"""PyTorch port vs JAX: the GOP-parallel decode of JAX-encoded streams.

The port's `decode_stream_gops(device="cpu")` must return the same
pictures, in the same order, as the JAX package's decoder."""

import numpy as np
import pytest
import torch

from dsv1_tpu.constants import (RATE_CONTROL_CRF, SUBSAMP_420, SUBSAMP_422,
                                quality_percent)
from dsv1_tpu.models.encoder import EncoderConfig
from dsv1_tpu.models.metadata import Metadata
from dsv1_tpu.parallel import decode_stream_gops, encode_stream_gops
import dsv1_tpu_torch as dt

from . import corpus

torch.set_num_threads(1)


def _with_cut(frames, cut_at):
    """A hard scene cut from frame cut_at on: luma brightened by 90, so
    the average-luma scene-change test fires (corpus.make_clip_frames'
    inverted-luma cut keeps the average of its mid-grey gradient)."""
    if cut_at < 0:
        return frames
    return [(np.clip(y.astype(np.int32) + 90, 0, 255).astype(np.uint8)
             if i >= cut_at else y, u, v)
            for i, (y, u, v) in enumerate(frames)]


@pytest.mark.parametrize("w,h,subsamp,nframes,gop,cut_at", [
    (100, 84, SUBSAMP_420, 10, 4, 6),     # odd ceil dims, a scene cut
    (96, 80, SUBSAMP_422, 6, 4, -1),
])
def test_decode_matches_jax(w, h, subsamp, nframes, gop, cut_at):
    frames = _with_cut(corpus.make_clip_frames(w, h, subsamp, nframes,
                                               seed=3), cut_at)
    cfg = EncoderConfig(quality=quality_percent(85), gop=gop,
                        rc_mode=RATE_CONTROL_CRF, stable_refresh=gop - 1)
    stream = encode_stream_gops(frames, Metadata(w, h, subsamp), cfg)
    jmeta, want = decode_stream_gops(stream)
    tmeta, got = dt.decode_stream_gops(stream, device="cpu")
    assert vars(tmeta) == vars(jmeta)   # the port's own Metadata class
    assert [f for f, _ in got] == [f for f, _ in want]
    for (_, gp), (_, wp) in zip(got, want):
        for a, b in zip(gp, wp):
            np.testing.assert_array_equal(a, np.asarray(b))
