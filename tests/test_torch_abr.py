"""PyTorch port vs JAX: the per-frame ABR path.

- `ops/piclen.py picture_len` equals the JAX package's and the length of
  the picture the native packer emits, at the densities of
  tests/test_piclen.py.
- `ops/rc.py`'s law equals the JAX law over random (has_ref, forced,
  pic_len) sequences, state and quality at every step.
- `encode_stream_gops` with ABR gives the bytes of the JAX package's
  in-scan ABR (`abr_mode="exact"`).
Exact equality throughout; inputs from numpy seeds."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsv1_tpu import bits as jbits
from dsv1_tpu.constants import (FOURCC, MAX_QP_BITS, RATE_CONTROL_ABR,
                                SUBSAMP_420, VERSION_MINOR, make_pt,
                                quality_percent)
from dsv1_tpu.models.encoder import EncoderConfig
from dsv1_tpu.models.metadata import Metadata
from dsv1_tpu.ops import piclen as jpiclen, rc as jrc
from dsv1_tpu.ops.hzcc import runs_from_qvals
from dsv1_tpu.parallel import encode_stream_gops
import dsv1_tpu_torch as dt
from dsv1_tpu_torch.ops import piclen as tpiclen, rc as trc

from . import corpus

torch.set_num_threads(1)


def _rand_case(rng, nbh, nbv, sizes, density):
    nblk = nbh * nbv
    stable = (rng.random(nblk) < 0.5).astype(np.uint8)
    stable |= (rng.random(nblk) < 0.2).astype(np.uint8) << 1
    mode = (rng.random(nblk) < 0.3).astype(np.uint8)  # 1 = intra
    mvx = np.where(mode == 0, rng.integers(-600, 600, nblk), 0).astype(np.int16)
    mvy = np.where(mode == 0, rng.integers(-600, 600, nblk), 0).astype(np.int16)
    submask = np.where(rng.random(nblk) < 0.5, 0xF,
                       rng.integers(0, 15, nblk)).astype(np.uint8)
    submask = np.where(mode == 1, submask, 0).astype(np.uint8)
    qvals = [np.where(rng.random(n) < density, rng.integers(-3000, 3000, n),
                      0).astype(np.int32) for n in sizes]
    dcs = [int(rng.integers(-512, 512)) for _ in sizes]
    return stable, mode, mvx, mvy, submask, qvals, dcs


@pytest.mark.parametrize("has_ref", [False, True])
@pytest.mark.parametrize("density", [0.0, 0.02, 0.4, 1.0])
def test_picture_len_matches_jax_and_packer(has_ref, density):
    rng = np.random.default_rng(int(density * 100) + 7 * has_ref)
    nbh, nbv = 7, 5
    for _trial in range(3):
        stable, mode, mvx, mvy, submask, qvals, dcs = _rand_case(
            rng, nbh, nbv, (1200, 311, 320), density)
        quant = int(rng.integers(5, 2047))
        pkt = dt.bits.pack_picture(
            FOURCC, VERSION_MINOR, make_pt(True, has_ref), 42, 32, 16,
            nbh, nbv, stable, has_ref, mode, mvx, mvy, submask, quant,
            MAX_QP_BITS, [(*runs_from_qvals(q), d)
                          for q, d in zip(qvals, dcs)])
        want = int(jpiclen.picture_len(
            32, 16, nbh, nbv, MAX_QP_BITS, stable, has_ref, mode, mvx, mvy,
            submask, qvals, dcs, maybe_p=True))
        t = torch.from_numpy
        got = tpiclen.picture_len(
            32, 16, nbh, nbv, MAX_QP_BITS, t(stable), has_ref, t(mode),
            t(mvx), t(mvy), t(submask), [t(q) for q in qvals],
            [torch.tensor(d) for d in dcs])
        assert got.dtype == torch.int32
        assert int(got) == want == len(pkt)


@pytest.mark.parametrize("nudge,kbps,seed", [(True, 300, 0), (False, 40, 1),
                                             (True, 6000, 2)])
def test_abr_law_matches_jax(nudge, kbps, seed):
    cfg = SimpleNamespace(bitrate=kbps * 1024, max_q_step=10,
                          min_quality=quality_percent(1),
                          max_quality=quality_percent(100),
                          min_I_frame_quality=quality_percent(5),
                          rc_high_motion_nudge=nudge)
    meta = SimpleNamespace(fps_num=30, fps_den=1)
    jq, js = jrc.make_abr_law(cfg, meta)
    tq, ts = trc.make_abr_law(cfg, meta)
    quality = quality_percent(85) * 3 // 2
    jst = jnp.asarray(jrc.init_state(quality))
    tst = trc.init_state(quality, "cpu")
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    rng = np.random.default_rng(seed)
    for _ in range(300):   # crosses the BPF_RESET window (256)
        is_p = bool(rng.random() < 0.8)
        forced = bool(rng.random() < 0.15) or not is_p
        plen = int(rng.integers(1, 40000) * rng.choice([1, 10, 100]))
        qj, jst = jq(jst, jnp.bool_(is_p), jnp.bool_(forced))
        qt, tst = tq(tst, is_p, forced)
        assert int(qt) == int(qj)
        jst = js(jst, jnp.bool_(is_p), qj, plen)
        tst = ts(tst, is_p, int(qt), torch.tensor(plen, dtype=torch.int32))
        np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))


def _abr_cfg(cls, g, kbps=300, **kw):
    kw.setdefault("stable_refresh", max(g - 1, 1))
    return cls(quality=min(quality_percent(85) * 3 // 2, 2047), gop=g,
               rc_mode=RATE_CONTROL_ABR, bitrate=kbps * 1024,
               max_quality=quality_percent(100), **kw)


@pytest.mark.parametrize("nframes,gop,cut_at,seed", [
    (18, 4, -1, 5),
    (14, 6, 4, 9),    # a scene cut inside a GOP: a forced-intra P slot
])
def test_abr_encode_matches_jax(nframes, gop, cut_at, seed):
    frames = corpus.make_clip_frames(96, 80, SUBSAMP_420, nframes,
                                     seed=seed, cut_at=cut_at)
    meta = Metadata(96, 80, SUBSAMP_420)
    want = encode_stream_gops(frames, meta, _abr_cfg(EncoderConfig, gop),
                              abr_mode="exact")
    got = dt.encode_stream_gops(iter(frames), dt.Metadata(96, 80,
                                                          SUBSAMP_420),
                                _abr_cfg(dt.EncoderConfig, gop),
                                device="cpu")
    assert got == want
    # the quant moves from picture to picture: the port's decoder reads
    # it per picture and gives back the JAX decode of the same stream
    from dsv1_tpu.parallel import decode_stream_gops
    quants = {jbits.parse_picture(p, 96, 80, MAX_QP_BITS, 16, 64,
                                  (8000, 2000, 2000))[0]["quant"]
              for p in _pictures(want)}
    assert len(quants) > 1
    _jm, jdec = decode_stream_gops(want)
    _tm, tdec = dt.decode_stream_gops(got, device="cpu")
    assert len(tdec) == len(jdec) == nframes
    for (fa, pa), (fb, pb) in zip(tdec, jdec):
        assert fa == fb
        for a, b in zip(pa, pb):
            np.testing.assert_array_equal(a, np.asarray(b))


def _pictures(stream):
    from dsv1_tpu.constants import pt_is_pic
    from dsv1_tpu.models.bitstream import iter_packets
    return [p for t, p in iter_packets(stream) if pt_is_pic(t)]
