"""PyTorch port vs JAX: the batched decode (several chains through each
launch, a quant per picture).

- `chains_per_device` (and the chunk over a GOP mesh) against the JAX
  package's `_plan_stream` chunk;
- `decode_stream_gops` on streams whose chains do not divide the chunk,
  a per-frame ABR stream (a quant per picture, several quants in one
  frame index) and a 4:2:2 stream, against the JAX package's decoded
  planes, each frame index's P pictures of a chunk through one MC call;
- `inv_sbt` and `dequant_plane_grid` on a batch of planes with a quant
  (and a DC) per plane, against the JAX twins plane by plane.

The streams are the port's own CPU encodes (the port's encoder equals the
JAX package's byte for byte, tests/test_torch_encode.py), so only the
JAX decoder is compiled here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsv1_tpu.constants import (RATE_CONTROL_ABR, RATE_CONTROL_CRF,
                                SUBSAMP_420, SUBSAMP_422, quality_percent)
from dsv1_tpu.models.bitstream import (iter_packets, parse_metadata,
                                       parse_packet_hdr)
from dsv1_tpu.constants import PT_META, pt_is_pic
from dsv1_tpu.ops import hzcc as jhzcc, sbt as jsbt
from dsv1_tpu.parallel import decode_stream_gops, gop_mesh
from dsv1_tpu.parallel import decode as jdec
import dsv1_tpu_torch as dt
from dsv1_tpu_torch.ops import hzcc as thzcc, sbt as tsbt
from dsv1_tpu_torch.parallel import decode as tdec
from dsv1_tpu_torch.utils.stats import STATS

from . import corpus

torch.set_num_threads(1)


def _stream(w, h, subsamp, nframes, gop, abr=False, seed=5):
    frames = corpus.make_clip_frames(w, h, subsamp, nframes, seed=seed)
    kw = dict(gop=gop, stable_refresh=gop - 1)
    if abr:
        cfg = dt.EncoderConfig(rc_mode=RATE_CONTROL_ABR, bitrate=40_000,
                               **kw)
    else:
        cfg = dt.EncoderConfig(rc_mode=RATE_CONTROL_CRF,
                               quality=quality_percent(85), **kw)
    return dt.encode_stream_gops(frames, dt.Metadata(w, h, subsamp), cfg,
                                 device="cpu")


def _jax_frames(stream):
    meta, frames = None, []
    for _t, pkt in iter_packets(stream):
        t = parse_packet_hdr(pkt)
        if t == PT_META:
            meta = parse_metadata(pkt)
        elif pt_is_pic(t) and meta is not None:
            frames.append(jdec._parse_picture(pkt, meta))
    return meta, frames


@pytest.mark.parametrize("nframes,gop,ndev", [(22, 4, 0), (22, 4, 2),
                                              (10, 12, 0), (40, 3, 3)])
def test_chunk_rule_matches_jax(nframes, gop, ndev):
    w, h = 96, 80
    stream = _stream(w, h, SUBSAMP_420, nframes, gop)
    jmeta, jframes = _jax_frames(stream)
    mesh = gop_mesh(jax.devices()[:ndev]) if ndev else None
    want = jdec._plan_stream(jmeta, jframes, mesh)[4]
    chains = tdec._plan_stream(jframes)
    assert chains == jdec._plan_stream(jmeta, jframes, mesh)[3]
    assert tdec.chains_per_device(chains, w, h) * max(ndev, 1) == want


@pytest.mark.parametrize("w,h,subsamp,nframes,gop,abr", [
    (96, 80, SUBSAMP_420, 22, 4, False),   # 6 chains: chunks of 4 and 2
    (96, 80, SUBSAMP_420, 14, 4, True),    # a quant per picture
    (96, 80, SUBSAMP_422, 10, 4, False),
])
def test_batched_decode_matches_jax(w, h, subsamp, nframes, gop, abr):
    stream = _stream(w, h, subsamp, nframes, gop, abr)
    _jm, want = decode_stream_gops(stream)
    STATS.clear()
    _tm, got = dt.decode_stream_gops(stream, device="cpu")
    assert [f for f, _ in got] == [f for f, _ in want]
    for (_, gp), (_, wp) in zip(got, want):
        for a, b in zip(gp, wp):
            np.testing.assert_array_equal(a, np.asarray(b))
    # every frame index's P pictures of a chunk in one MC call
    chains = -(-nframes // gop)
    per = min(4, chains)
    calls = sum(gop - 1 if min(gop, nframes - c * gop) == gop
                else nframes - c * gop - 1 for c in range(0, chains, per))
    assert STATS["decode_p"] == nframes - chains
    assert STATS["decode_p_calls"] == calls
    if abr:
        _jm, jfr = _jax_frames(stream)
        assert len({f["quant"] for f in jfr}) > 1


@pytest.mark.parametrize("W,H,is_p,c", [(96, 80, True, 0),
                                        (96, 80, False, 0),
                                        (48, 40, True, 1),
                                        (50, 42, False, 2)])
def test_per_plane_quants_match_jax(W, H, is_p, c):
    rng = np.random.default_rng(W + H + c)
    q = np.array([137, 1024, 9, 3000, 500], np.int32)
    B = q.size
    nbh, nbv = -(-W // 16), -(-H // 16)
    qgrid = np.where(rng.random((B, H, W)) < 0.3,
                     rng.integers(-40, 41, (B, H, W)), 0).astype(np.int32)
    dc = rng.integers(-500, 500, B).astype(np.int32)
    stable = rng.integers(0, 4, (B, nbh * nbv)).astype(np.uint8)
    jt = jhzcc.build_tables(W, H, nbh, nbv)
    tt = thzcc.build_tables(W, H, nbh, nbv)
    got = thzcc.dequant_plane_grid(torch.from_numpy(qgrid),
                                   torch.from_numpy(dc), torch.from_numpy(q),
                                   is_p, c, torch.from_numpy(stable), tt)
    rec = tsbt.inv_sbt(got, torch.from_numpy(q), is_p, is_luma=(c == 0))
    for b in range(B):
        want = jhzcc.dequant_plane_grid(jnp.asarray(qgrid[b]), int(dc[b]),
                                        int(q[b]), is_p, c,
                                        jnp.asarray(stable[b]), jt)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))
        wrec = jsbt.inv_sbt(want, int(q[b]), is_p, c == 0)
        np.testing.assert_array_equal(rec[b].numpy(), np.asarray(wrec))
