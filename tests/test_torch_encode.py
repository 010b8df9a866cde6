"""PyTorch port vs JAX: the GOP-parallel CRF encode, byte for byte.

The port's `encode_stream_gops(device="cpu")` stream must equal the JAX
package's `encode_stream_gops` stream for the same frames and config."""

import numpy as np
import pytest
import torch

from dsv1_tpu.constants import (RATE_CONTROL_CRF, SUBSAMP_420, SUBSAMP_444,
                                quality_percent)
from dsv1_tpu.models.bitstream import iter_packets, parse_packet_hdr
from dsv1_tpu.models.encoder import EncoderConfig
from dsv1_tpu.models.metadata import Metadata
from dsv1_tpu.parallel import encode_stream_gops
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


@pytest.mark.parametrize("w,h,subsamp,nframes,gop,cut_at,refresh", [
    (96, 80, SUBSAMP_420, 8, 4, -1, 3),
    (100, 84, SUBSAMP_420, 14, 12, -1, 11),   # odd ceil dims, tail GOP of 2
    (96, 80, SUBSAMP_420, 10, 8, 5, 7),   # scene cut: a forced-intra P slot
    (96, 80, SUBSAMP_444, 8, 4, -1, 3),
    # GOPs 1 and 2 start mid-refresh (counter 3, then 1): their I frames
    # read the stability accumulators carried out of the previous GOP
    (96, 80, SUBSAMP_420, 12, 4, -1, 5),
])
def test_encode_stream_matches_jax(w, h, subsamp, nframes, gop, cut_at,
                                   refresh):
    frames = _with_cut(corpus.make_clip_frames(w, h, subsamp, nframes,
                                               seed=7), cut_at)
    meta = Metadata(w, h, subsamp)
    kw = dict(quality=quality_percent(85), gop=gop, stable_refresh=refresh)
    want = encode_stream_gops(frames, meta,
                              EncoderConfig(rc_mode=RATE_CONTROL_CRF, **kw))
    got = dt.encode_stream_gops(frames, meta, dt.EncoderConfig(**kw),
                                device="cpu")
    assert len(got) == len(want)
    assert got == want
    if cut_at >= 0:
        # the cut forced an intra picture inside a GOP: one more intra
        # reference picture (PT 0x06) than there are GOPs
        types = [parse_packet_hdr(p) for _t, p in iter_packets(want)]
        assert types.count(0x06) > -(-nframes // gop)


def test_encode_rejects_what_is_not_ported():
    frames = corpus.make_clip_frames(32, 32, SUBSAMP_420, 2, seed=1)
    meta = Metadata(32, 32, SUBSAMP_420)
    # ABR at gop 0 and gop > 4096 belong to the sequential Encoder
    for cfg in (dt.EncoderConfig(gop=0, rc_mode=dt.RATE_CONTROL_ABR),
                dt.EncoderConfig(gop=4097)):
        with pytest.raises(ValueError, match="use models.encoder.Encoder"):
            dt.encode_stream_gops(frames, meta, cfg, device="cpu")
    # GOP-granular ABR runs (tests/test_torch_gopabr.py); an unknown
    # abr_mode is refused
    with pytest.raises(ValueError, match="abr_mode"):
        dt.encode_stream_gops(frames, meta, EncoderConfig(gop=2, rc_mode=1),
                              device="cpu", abr_mode="frame")
