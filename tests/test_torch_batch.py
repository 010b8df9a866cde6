"""PyTorch port vs JAX: several GOPs through each kernel launch.

The port's GOP encoder runs a chunk of C GOPs at once (the JAX
package's `gops_per_device`): one HME call over the chunk's P-frame
pairs, then frame index by frame index the chunk's frames of one type
through one call of the encode core, so `bmc.compensate_frame`,
`sbt.fwd_sbt` / `inv_sbt`, `hzcc.encode_plane_core`, the compactions and
the stability update take a leading batch axis. Each batched function is
held to the JAX function on each batch element; `encode_stream_gops` at
1, 2 and 4 GOPs a chunk to the JAX package's stream, over stability
refresh periods that carry state across GOPs, a scene cut inside one GOP
of a chunk, 4:2:2, effort 2 and a padded tail chunk (GOP-granular ABR
in chunks: test_torch_batch_abr.py). The JAX package's CRF bytes do not
depend on its chunk (it replays the stability chain); the slow tier
checks that for every case, so the tier-1 cases compare with JAX at 2
GOPs a chunk."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsv1_tpu.constants import SUBSAMP_420, SUBSAMP_422
from dsv1_tpu.models.encoder import EncoderConfig as JConfig
from dsv1_tpu.models.metadata import Metadata as JMeta
from dsv1_tpu.ops import bmc as jbmc, frame as jfr, hzcc as jhz, sbt as jsbt
from dsv1_tpu.parallel import encode_stream_gops as jencode, gop as jgop
import dsv1_tpu_torch as dt
from dsv1_tpu_torch.models import encoder as tenc
from dsv1_tpu_torch.ops import bmc as tbmc, frame as tfr, hzcc as thz
from dsv1_tpu_torch.ops import sbt as tsbt
from dsv1_tpu_torch.parallel.gop import gops_per_chunk
from dsv1_tpu_torch.utils import corpus as tcorpus
from dsv1_tpu_torch.utils.stats import STATS

torch.set_num_threads(1)

W, H, C = 96, 80, 3


def _frames(w, h, subsamp, n, seed=21, cut_at=-1):
    """A clip as (y, u, v) numpy frames (the port's generator; cut_at
    halves the luma from that frame on: a scene cut)."""
    yuv = tcorpus.make_clip(w, h, subsamp, n, seed=seed, cut_at=cut_at)
    return tcorpus.split_frames(yuv, w, h, subsamp, n)


def test_compensate_frame_batch_matches_jax():
    """C frames' predictions in one call, each plane of each frame equal
    to JAX compensate_plane (XLA form) on that frame alone: fuzzed
    modes, submasks and MVs past the plane edges."""
    blk, nbh, nbv = 16, 6, 5
    rng = np.random.default_rng(3)
    layout = jfr.make_layout(SUBSAMP_420, W, H, True)
    tl = tfr.make_layout(SUBSAMP_420, W, H, True)
    imgs, fields = [], []
    for z, planes in enumerate(_frames(W, H, SUBSAMP_420, C)):
        imgs.append(np.asarray(jfr.image_from_planes(
            layout, [jnp.asarray(p) for p in planes])))
        nb = nbh * nbv
        fields.append((rng.integers(0, 2, nb), rng.integers(-2 * W, 2 * W, nb),
                       rng.integers(-2 * H, 2 * H, nb),
                       rng.integers(0, 16, nb)))
    fields = [np.stack([f[k] for f in fields]).astype(np.int32)
              for k in range(4)]
    got = tbmc.compensate_frame(torch.from_numpy(np.stack(imgs)), tl, blk,
                                blk, nbh, nbv,
                                *[torch.from_numpy(a) for a in fields])
    for z in range(C):
        img = jnp.asarray(imgs[z])
        for c in range(3):
            want = jbmc.compensate_plane(
                img, jfr.plane_view(img, layout, c), layout, c, blk, blk,
                nbh, nbv, *[jnp.asarray(a[z]) for a in fields],
                pallas_ok=False)
            np.testing.assert_array_equal(got[c][z].numpy(),
                                          np.asarray(want),
                                          err_msg=f"frame {z} plane {c}")


@pytest.mark.parametrize("is_p", [False, True])
def test_sbt_batch_matches_jax(is_p):
    """fwd_sbt of C planes at once (the batched Haar pyramid, B4T for
    intra planes) and inv_sbt of its output, luma and chroma, equal to
    JAX on each plane."""
    rng = np.random.default_rng(4 + is_p)
    a = rng.integers(-128, 128, (C, H, W)).astype(np.int32)
    fwd = tsbt.fwd_sbt(torch.from_numpy(a), is_p)
    for z in range(C):
        np.testing.assert_array_equal(
            fwd[z].numpy(), np.asarray(jsbt.fwd_sbt(jnp.asarray(a[z]),
                                                    is_p=is_p)))
    for luma in (True, False):
        inv = tsbt.inv_sbt(fwd, 700, is_p, luma)
        for z in range(C):
            want = jsbt.inv_sbt(jnp.asarray(fwd[z].numpy()), 700,
                                is_p=is_p, is_luma=luma)
            np.testing.assert_array_equal(inv[z].numpy(), np.asarray(want))


@pytest.mark.parametrize("is_p,plane", [(False, 0), (True, 0), (True, 2)])
def test_encode_plane_core_batch_matches_jax(is_p, plane):
    """HZCC quantization with write-back of C planes, each with its own
    stable blocks, equal to JAX on each plane."""
    nbh, nbv = 6, 5
    rng = np.random.default_rng(7 + plane)
    coefs = np.stack([np.asarray(jsbt.fwd_sbt(jnp.asarray(
        rng.integers(-128, 128, (H, W)).astype(np.int32)), is_p=is_p))
        for _ in range(C)])
    stable = rng.integers(0, 4, (C, nbh * nbv)).astype(np.uint8)
    jt = jhz.build_tables(W, H, nbh, nbv)
    tq, twb = thz.encode_plane_core(torch.from_numpy(coefs), 900, is_p,
                                    plane, torch.from_numpy(stable),
                                    thz.build_tables(W, H, nbh, nbv))
    for z in range(C):
        jq, jwb = jhz.encode_plane_core(jnp.asarray(coefs[z]), 900, is_p,
                                        plane, jnp.asarray(stable[z]), jt)
        np.testing.assert_array_equal(tq[z].numpy(), np.asarray(jq))
        np.testing.assert_array_equal(twb[z].numpy(), np.asarray(jwb))


def test_compactions_batch_match_jax():
    """compact_sparse_p and compact_dense_i on C planes at once, each
    element of each output (overflow verdicts included: one plane has
    too many nonzeros, one a value past int16, one large LL values)
    equal to JAX on each plane."""
    rng = np.random.default_rng(11)
    n, ll_n = 5000, 400
    q = np.where(rng.random((C, n)) < [[0.01], [0.5], [0.002]],
                 rng.integers(-200, 200, (C, n)), 0).astype(np.int32)
    q[2, 17] = 40000
    q[0, :ll_n:7] = 300
    got = thz.compact_sparse_p(torch.from_numpy(q), 16)
    got_i = thz.compact_dense_i(torch.from_numpy(q), ll_n)
    for z in range(C):
        want = jhz.compact_sparse_p(jnp.asarray(q[z]), 16)
        np.testing.assert_array_equal(got[0][z].numpy().view(np.uint16),
                                      np.asarray(want[0]))
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g[z].numpy(), np.asarray(w))
        for g, w in zip(got_i, jhz.compact_dense_i(jnp.asarray(q[z]),
                                                   ll_n)):
            np.testing.assert_array_equal(g[z].numpy(), np.asarray(w))
    assert [bool(v) for v in got[3]] == [False, True, True]


def test_stable_update_batch_matches_jax():
    """The stability update of k GOPs at one frame index, each with its
    own counter (one at the refresh period: a reset), P and intra frames
    mixed, equal to JAX's on each GOP."""
    k, nblk, sr = 4, 30, 5
    rng = np.random.default_rng(13)
    stab = rng.integers(-40, 40, (k, nblk, 2)).astype(np.int32)
    ctrs, is_p = [0, 2, 5, 3], [True, False, True, True]
    mv = {"mode": rng.integers(0, 2, (k, nblk)),
          "mvx": rng.integers(-90, 90, (k, nblk)),
          "mvy": rng.integers(-90, 90, (k, nblk)),
          "lo_tex": rng.random((k, nblk)) < 0.2,
          "lo_var": rng.random((k, nblk)) < 0.2,
          "high_detail": rng.random((k, nblk)) < 0.3}
    mv = {key: v.astype(np.int32) for key, v in mv.items()}
    got_s, got_c, got_b = tenc._stable_update(
        torch.from_numpy(stab), ctrs, is_p,
        {key: torch.from_numpy(v) for key, v in mv.items()}, sr)
    for z in range(k):
        js, jc, jb = jgop._stable_update(
            jnp.asarray(stab[z]), jnp.int32(ctrs[z]), jnp.bool_(is_p[z]),
            {key: jnp.asarray(v[z]) for key, v in mv.items()}, sr)
        np.testing.assert_array_equal(got_s[z].numpy(), np.asarray(js))
        assert got_c[z] == int(jc)
        np.testing.assert_array_equal(got_b[z].numpy(), np.asarray(jb))


def test_gops_per_chunk_follows_the_jax_rule(monkeypatch):
    """The JAX package's chunk rule (parallel/gop.py:1271-1275): up to 4
    GOPs of CIF size, 1 at 1080p, at most the input's GOPs, 1 under ABR
    unless asked, DSV1_GOPS_PER_DEVICE when set."""
    crf = dt.EncoderConfig(gop=12)
    abr = dt.EncoderConfig(gop=12, rc_mode=dt.RATE_CONTROL_ABR)
    monkeypatch.delenv("DSV1_GOPS_PER_DEVICE", raising=False)
    assert gops_per_chunk(crf, 352, 288) == 4
    assert gops_per_chunk(crf, 352, 288, 24) == 2
    assert gops_per_chunk(crf, 704, 576) == 1
    assert gops_per_chunk(crf, 1920, 1080) == 1
    assert gops_per_chunk(crf, 1920, 1080, 0, 3) == 3
    assert gops_per_chunk(abr, 352, 288) == 1
    assert gops_per_chunk(abr, 352, 288, 0, 2) == 2
    monkeypatch.setenv("DSV1_GOPS_PER_DEVICE", "3")
    assert gops_per_chunk(crf, 1920, 1080) == 3
    assert gops_per_chunk(abr, 352, 288) == 1


# name: (subsamp, frames, gop, stable_refresh, effort, cut_at)
CASES = {
    "refresh": (SUBSAMP_420, 16, 4, 3, 0, -1),   # stable_refresh = gop - 1
    "carried": (SUBSAMP_420, 14, 6, 4, 0, -1),   # the JAX replay fires
    "cut": (SUBSAMP_420, 16, 4, 3, 0, 6),        # scene cut inside GOP 1
    "422": (SUBSAMP_422, 16, 4, 3, 0, -1),
    "effort": (SUBSAMP_420, 16, 4, 3, 2, -1),
    "tail": (SUBSAMP_420, 14, 4, 3, 0, -1),      # a padded tail chunk
}
_JAX = {}


def _case(name):
    subsamp, n, gop, sr, effort, cut = CASES[name]
    frames = _frames(W, H, subsamp, n, cut_at=cut)
    kw = dict(gop=gop, stable_refresh=sr, effort=effort)
    return frames, subsamp, kw


def _jax_stream(name, gpd=2):
    if (name, gpd) not in _JAX:
        frames, subsamp, kw = _case(name)
        _JAX[name, gpd] = jencode(frames, JMeta(W, H, subsamp), JConfig(**kw),
                                  gops_per_device=gpd)
    return _JAX[name, gpd]


@pytest.mark.parametrize("gpd", [1, 2, 4])
@pytest.mark.parametrize("name", sorted(CASES))
def test_encode_stream_gops_batch_matches_jax(name, gpd):
    frames, subsamp, kw = _case(name)
    STATS.clear()
    got = dt.encode_stream_gops(frames, dt.Metadata(W, H, subsamp),
                                dt.EncoderConfig(**kw), "cpu", gpd)
    assert got == _jax_stream(name)
    G, n = kw["gop"], len(frames)
    assert STATS["chunks"] == -(-n // (G * gpd))
    assert STATS["core_p"] + STATS["core_i"] == STATS["chunks"] * gpd * G
    if name in ("carried", "cut"):
        # GOPs started from carried stability states (the ones the JAX
        # package encodes twice)
        assert STATS["stab_carried"] > 0
    if name == "cut" and gpd > 1:
        # one frame index held P frames and the cut's intra frame
        assert STATS["core_calls_i"] > STATS["chunks"]
    if name == "refresh":
        assert STATS["stab_carried"] == 0


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(CASES))
def test_jax_bytes_do_not_depend_on_the_chunk(name):
    """The JAX package at 1 and 4 GOPs a chunk gives its stream at 2, so
    each tier-1 case above also equals JAX at the port's own chunk."""
    assert _jax_stream(name, 1) == _jax_stream(name) \
        == _jax_stream(name, 4)


@pytest.mark.parametrize("gpd", [1, 2])
def test_exact_abr_tail_matches_jax(gpd):
    """Per-frame ABR runs one GOP at a time whatever gops_per_device
    says (its bytes do not depend on the chunk): 13 frames at gop 4 and
    stable_refresh 5, so GOPs and the one-frame tail GOP start from
    carried stability states."""
    frames = _frames(W, H, SUBSAMP_420, 13)
    kw = dict(gop=4, stable_refresh=5, rc_mode=dt.RATE_CONTROL_ABR,
              bitrate=300 * 1024, quality=1900, max_quality=dt.MAX_QUALITY)
    if "abr" not in _JAX:
        _JAX["abr"] = jencode(frames, JMeta(W, H, SUBSAMP_420),
                              JConfig(**kw), abr_mode="exact")
    STATS.clear()
    got = dt.encode_stream_gops(frames, dt.Metadata(W, H, SUBSAMP_420),
                                dt.EncoderConfig(**kw), "cpu", gpd)
    assert got == _JAX["abr"]
    assert STATS["chunks"] == 4 and STATS["stab_carried"] >= 2
