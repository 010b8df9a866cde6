"""PyTorch port vs JAX: beyond-reference motion search (effort 1..3).

Every case feeds the same numpy inputs, made from a seed, to the JAX
package and to the port (on the CPU: the kernels' plain versions) and
asks for equal results:

- `refine_level_plain` at level 0 against the Pallas `_refine_kernel`
  in interpret mode, with 64-wide blocks in the E = 64 border and
  candidates just inside the +-E validity limits (there the Pallas
  kernel's clamped windows and the XLA search's flat reads agree), and
  against the XLA `_refine_common(0, ...)` (the CPU route, which wrote
  the goldens) with candidates on the limits and past them;
- `refine_wide_plain` + `refine_base_from_kernel` against the JAX
  package's `refine_base(pre=..., effort=e)`, with `pre` pinned at the
  four edges of the 9-point search: with 64x64 blocks the wide window
  leaves the extended plane on every side, and at effort >= 2 reaches
  rows before the image's start (clipped as the JAX gather clips them);
- the port's `hme_batch(effort=2)` against both JAX routes (XLA `hme`
  and `hme_batch` through the Pallas kernels in interpret mode), and at
  the +-64 level-0 limit, where the two routes differ, at effort 0 and
  2 against the XLA route exactly (every coarse level too);
- `encode_stream_gops` at CRF effort 2, the sequential `Encoder` at
  effort 2 (resumed from a JAX state_dict too), and the CLI with
  -effort1 under per-frame ABR, with -gopabr1 and on -gopar0, decoded
  too, against the JAX stream and decode;
- the `Decoder`'s and `iter_decode_gops`' last frame against the
  sequential `Encoder`'s reconstruction, at effort 0 and 2.

One case of each kind runs in tier-1, the rest are `slow`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsv1_tpu.constants import (RATE_CONTROL_CRF, SUBSAMP_420, round_shift,
                                quality_percent)
from dsv1_tpu.models.encoder import Encoder as JEncoder, EncoderConfig
from dsv1_tpu.models.metadata import Metadata
from dsv1_tpu.ops import frame as jfr, hme as jhme, pallas_hme
from dsv1_tpu.parallel import encode_stream_gops
import dsv1_tpu_torch as dt
from dsv1_tpu_torch.ops import frame as tfr, hme as thme, hme_kernels as hk
from dsv1_tpu_torch.utils.edges import edge_cands, edge_pre

from . import corpus
from .test_torch_cli import test_cli_matches_jax as _cli_matches_jax
from .test_torch_hme import _frames, _pyramid

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _level0(w, h, pairs):
    """JAX flat level-0 images (B, n) of src and ref for (seed, shift)
    pairs, and the level-0 layout."""
    srcs, refs = [], []
    for seed, shift in pairs:
        f1, f0 = _frames(w, h, seed, shift)
        si, lays = _pyramid(f1, w, h)
        ri, _ = _pyramid(f0, w, h)
        srcs.append(np.asarray(si[0]))
        refs.append(np.asarray(ri[0]))
    return np.stack(srcs), np.stack(refs), lays[0]


LEVEL0_CASES = [
    pytest.param(192, 160, 64, 64, 1),
    pytest.param(200, 136, 64, 48, 2, marks=pytest.mark.slow),
]


@pytest.mark.parametrize("w,h,BW,BH,seed", LEVEL0_CASES)
def test_refine_level0_plain_matches_pallas(w, h, BW, BH, seed):
    """Kernel #2 at level 0: E = 64, 64-wide blocks, candidates two
    pixels inside the +-E validity limits in both axes, where no window
    of the search leaves the extended plane (so the Pallas clamp does
    not bind)."""
    s, r, lay = _level0(w, h, [(seed, 3), (seed + 1, 0)])
    s2, r2 = jhme._lvl2d(jnp.asarray(s), lay), jhme._lvl2d(jnp.asarray(r),
                                                          lay)
    nbh, nbv = -(-w // BW), -(-h // BH)
    nb = nbh * nbv
    E = lay.planes[0].ext
    cmx, cmy = (t.numpy() for t in edge_cands(
        np.random.default_rng(seed), "cpu", 2, nbh, nbv, w, h, BW, BH, E))
    t = np.arange(nb)
    bx, by = (t % nbh) * BW, (t // nbh) * BH
    cmx = np.clip(cmx, (2 - E - bx)[None, :, None],
                  (w + E - BW - 2 - bx)[None, :, None])
    cmy = np.clip(cmy, (2 - E - by)[None, :, None],
                  (h + E - BH - 2 - by)[None, :, None])
    cmx[..., 0] = cmy[..., 0] = 0
    want = pallas_hme.refine_level_pallas(
        s2, r2, jnp.asarray(cmx), jnp.asarray(cmy), lay, 0, BW, BH, nbh, nb,
        interpret=True)
    tl = tfr.make_layout(SUBSAMP_420, w, h, True)
    got = hk.refine_level(_t(s), _t(r), tl, _t(cmx), _t(cmy), nbh, nb, BW,
                          BH, 0)
    for g, e in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))


@pytest.mark.parametrize("w,h,BW,BH,seed", LEVEL0_CASES)
def test_refine_level0_plain_matches_xla_at_the_limit(w, h, BW, BH, seed):
    """Kernel #2 at level 0 against the XLA search (`_refine_common(0,
    ...)`, the CPU route): the parent field holds MVs on the +-E
    validity limits of its blocks, one inside and one past them, so the
    candidates, and the 9-point windows after them, reach past the
    extended plane, where the XLA search reads the flat image on."""
    s, r, lay = _level0(w, h, [(seed, 3), (seed + 1, 0)])
    nbh, nbv = -(-w // BW), -(-h // BH)
    nb = nbh * nbv
    E = lay.planes[0].ext
    cmx, cmy = (t.numpy() for t in edge_cands(
        np.random.default_rng(seed), "cpu", 2, nbh, nbv, w, h, BW, BH, E))
    # the parent field: each block's MV one of its edge candidates
    k = np.random.default_rng(seed + 1).integers(1, 6, (2, nb))
    mvf = np.stack([np.take_along_axis(c, k[..., None], -1)[..., 0]
                    for c in (cmx, cmy)], -1).reshape(2, nbv, nbh, 2)
    tl = tfr.make_layout(SUBSAMP_420, w, h, True)
    tcx, tcy = hk._build_cands_batched(0, _t(mvf), nbh, nbv)
    got = hk.refine_level(_t(s), _t(r), tl, tcx, tcy, nbh, nb, BW, BH, 0)
    xla = jax.jit(lambda m, s1, r1: jhme._refine_common(
        0, m, s1, r1, lay, BW, BH, nbh, nbv)[7:10])
    bx = (np.arange(nb) % nbh) * BW
    lim = np.stack([-E - bx, w + E - np.minimum(w - bx, BW) - bx])
    assert (np.abs(tcx.numpy()[..., None] - lim.T[None, :, None])
            <= 1).any(), "no candidate on the limit"
    for b in range(2):
        want = xla(jnp.asarray(mvf[b]), jnp.asarray(s[b]), jnp.asarray(r[b]))
        for name, g, e in zip(("dx", "dy", "best"), got, want):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(e),
                                          err_msg=f"{name} pair {b}")


WIDE_CASES = [
    pytest.param(192, 160, 64, 64, 3, 5),       # the clipped top rows
    pytest.param(192, 160, 64, 64, 1, 6, marks=pytest.mark.slow),
    pytest.param(192, 160, 64, 64, 2, 7, marks=pytest.mark.slow),
    pytest.param(200, 136, 64, 48, 3, 8, marks=pytest.mark.slow),
    pytest.param(100, 84, 16, 16, 2, 9, marks=pytest.mark.slow),
]


@pytest.mark.parametrize("w,h,BW,BH,effort,seed", WIDE_CASES)
def test_refine_wide_plain_matches_jax(w, h, BW, BH, effort, seed):
    s, r, lay = _level0(w, h, [(seed, 2), (seed + 1, 0)])
    nbh, nbv = -(-w // BW), -(-h // BH)
    pre = [t.numpy() for t in edge_pre(np.random.default_rng(seed), "cpu", 2,
                                       nbh, nbv, w, h, BW, BH)]
    tl = tfr.make_layout(SUBSAMP_420, w, h, True)
    kouts = hk.refine_wide(_t(s), _t(r), tl, nbh, nbh * nbv, BW, BH,
                           tuple(_t(a) for a in pre), effort)
    got = thme.refine_base_from_kernel(_t(s), _t(r), tl, BW, BH, nbh, nbv,
                                       SUBSAMP_420, kouts)
    jax_base = jax.jit(lambda s1, r1, pre1: jhme.refine_base(
        None, s1, r1, lay, BW, BH, nbh, nbv, SUBSAMP_420, pre=pre1,
        effort=effort))
    for b in range(2):
        want = jax_base(jnp.asarray(s[b]), jnp.asarray(r[b]),
                        tuple(jnp.asarray(a[b]) for a in pre))
        for key in ("mode", "mvx", "mvy", "submask", "lo_tex", "lo_var",
                    "high_detail", "nintra"):
            np.testing.assert_array_equal(got[key][b].numpy(),
                                          np.asarray(want[key]),
                                          err_msg=f"{key} pair {b}")


HME_CASES = [
    pytest.param(1, 3, 96, 80, "xla"),
    pytest.param(1, 3, 96, 80, "pallas", marks=pytest.mark.slow),
    pytest.param(3, 2, 100, 84, "xla", marks=pytest.mark.slow),
    pytest.param(3, 2, 100, 84, "pallas", marks=pytest.mark.slow),
]


@pytest.mark.parametrize("seed,shift,w,h,route", HME_CASES)
def test_hme_batch_effort_matches_jax(seed, shift, w, h, route):
    """The port's hme_batch at effort 2 against the JAX package's XLA
    `hme` (the CPU encoders' route) and its `hme_batch` through the
    Pallas kernels in interpret mode (the TPU's route)."""
    blk, levels, effort = 16, 3, 2
    f1, f0 = _frames(w, h, seed, shift)
    si, lays = _pyramid(f1, w, h)
    ri, _ = _pyramid(f0, w, h)
    nbh, nbv = -(-w // blk), -(-h // blk)
    if route == "xla":
        want = jax.jit(lambda s1, r1: jhme.hme(
            s1, r1, lays, blk, blk, nbh, nbv, SUBSAMP_420, levels,
            effort=effort))(si, ri)
    else:
        want = {k: v[0] for k, v in jhme.hme_batch(
            [a[None] for a in si], [a[None] for a in ri], lays, blk, blk,
            nbh, nbv, SUBSAMP_420, levels, interpret=True,
            effort=effort).items()}
    tl = [tfr.make_layout(SUBSAMP_420, lay.width, lay.height, True)
          for lay in lays]
    got = thme.hme_batch([_t(a)[None] for a in si], [_t(a)[None] for a in ri],
                         tl, blk, blk, nbh, nbv, SUBSAMP_420, levels,
                         effort=effort)
    for key in ("mode", "mvx", "mvy", "submask", "lo_tex", "lo_var",
                "high_detail", "intra_pct"):
        np.testing.assert_array_equal(got[key][0].numpy(),
                                      np.asarray(want[key]), err_msg=key)


def _panned_pyramids(w, h, sx, sy, levels, seed):
    """JAX flat images per level of a smooth textured scene (src) and of
    the same scene panned by (sx, sy) pixels (ref), and their layouts."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h + abs(sy), 0:w + abs(sx)].astype(np.float64)
    scene = (128 + 60 * np.sin(x / 23 + 0.7 * np.sin(y / 31))
             + 40 * np.cos(y / 17 - x / 41) + rng.normal(0, 4, x.shape))
    scene = np.clip(scene, 0, 255).astype(np.uint8)
    grey = np.full((h // 2, w // 2), 128, np.uint8)
    out = []
    for oy, ox in ((max(-sy, 0), max(-sx, 0)), (max(sy, 0), max(sx, 0))):
        lays = [jfr.make_layout(SUBSAMP_420, w, h, True)]
        imgs = [jfr.image_from_planes(lays[0], [jnp.asarray(
            scene[oy:oy + h, ox:ox + w]), jnp.asarray(grey),
            jnp.asarray(grey)])]
        for i in range(levels):
            pw, ph = round_shift(w, i + 1), round_shift(h, i + 1)
            lays.append(jfr.make_layout(SUBSAMP_420, pw, ph, True))
            imgs.append(jfr.image_from_luma(lays[-1], jfr.ds2x_luma(
                jfr.plane_view_ext(imgs[-1], lays[-2], 0, 1), pw, ph)))
        out.append(imgs)
    return out[0], out[1], lays


@pytest.mark.slow
@pytest.mark.parametrize("effort", [0, 2])
def test_hme_batch_effort_at_the_level0_limit(effort):
    """A pan of 64 pixels in both axes at 64x64 blocks and 6 levels pulls
    level-0 candidates and 9-point results onto the +-E (64) validity
    limit. There the JAX package's two routes differ: its Pallas kernel
    #2 clamps the 9-point windows into the extended plane, while XLA
    `hme` (the CPU encoders' route, which wrote the goldens) reads the
    flat image past it. The port follows the XLA route: every coarse
    level's field (each level from XLA's field of the level above) and
    the level-0 result equal it exactly, at effort 0 (kernel #3) and 2
    (kernel #2 at level 0, then `hme_wide`)."""
    w, h, blk, levels = 256, 192, 64, 6
    si, ri, lays = _panned_pyramids(w, h, -64, -64, levels, 3)
    nbh, nbv = -(-w // blk), -(-h // blk)
    xla = jax.jit(lambda s1, r1: jhme.hme(
        s1, r1, lays, blk, blk, nbh, nbv, SUBSAMP_420, levels,
        effort=effort))(si, ri)
    tl = [tfr.make_layout(SUBSAMP_420, lay.width, lay.height, True)
          for lay in lays]
    mvf = None
    for level in range(levels, 0, -1):
        step, ii, jj = hk._lvl_grid(level, nbh, nbv)
        if mvf is None:
            cmx = cmy = torch.zeros((1, len(ii) * len(jj), 1),
                                    dtype=torch.int32)
        else:
            cmx, cmy = hk._build_cands_batched(level, _t(mvf)[None], nbh,
                                               nbv)
        dx, dy, _ = hk.refine_level(_t(si[level])[None], _t(ri[level])[None],
                                    tl[level], cmx, cmy, len(ii),
                                    len(ii) * len(jj), blk, blk, level)
        mvf = np.asarray(jhme.refine_coarse(level, mvf, si[level], ri[level],
                                            lays[level], blk, blk, nbh, nbv))
        p = tl[level].planes[0]
        infr = ((((ii * blk) >> level)[None, :] < p.w)
                & (((jj * blk) >> level)[:, None] < p.h)).reshape(-1)
        for name, d, want in (("dx", dx, mvf[::step, ::step, 0]),
                              ("dy", dy, mvf[::step, ::step, 1])):
            np.testing.assert_array_equal(
                np.where(infr, d[0].numpy() << level, 0),
                want.reshape(-1), err_msg=f"level {level} {name}")
    calls = []
    got = thme.hme_batch([_t(a)[None] for a in si], [_t(a)[None] for a in ri],
                         tl, blk, blk, nbh, nbv, SUBSAMP_420, levels,
                         calls=calls, effort=effort)
    p = tl[0].planes[0]
    t = np.arange(nbh * nbv)
    bx, by = (t % nbh) * blk, (t // nbh) * blk
    lims = (np.stack([-p.ext - bx, w + p.ext - np.minimum(w - bx, blk) - bx]),
            np.stack([-p.ext - by, h + p.ext - np.minimum(h - by, blk) - by]))
    args = dict(calls)
    cm = (args["hme_base"][3] if effort == 0
          else torch.cat(args["hme_level0"][3:5], -1))
    nc = cm.shape[-1] // 2
    assert any((c[0].numpy().T[:, None] == lim[None]).any()
               for c, lim in zip((cm[..., :nc], cm[..., nc:]), lims)), \
        "no candidate on the limit"
    for key in ("mode", "mvx", "mvy", "submask", "lo_tex", "lo_var",
                "high_detail", "intra_pct"):
        np.testing.assert_array_equal(got[key][0].numpy(),
                                      np.asarray(xla[key]), err_msg=key)


W, H, G, NF = 96, 80, 4, 12   # as tests/test_effort.py


def _clip(nf=NF):
    return corpus.make_clip_frames(W, H, SUBSAMP_420, nf, seed=31)


def _crf(effort, cls=EncoderConfig):
    kw = dict(quality=quality_percent(70), gop=G, stable_refresh=G - 1,
              effort=effort)
    return cls(rc_mode=RATE_CONTROL_CRF, **kw) if cls is EncoderConfig \
        else cls(**kw)


@pytest.mark.parametrize("effort", [
    2, pytest.param(1, marks=pytest.mark.slow),
    pytest.param(3, marks=pytest.mark.slow)])
def test_encode_stream_gops_effort_matches_jax(effort):
    frames, meta = _clip(), Metadata(W, H, SUBSAMP_420)
    want = encode_stream_gops(frames, meta, _crf(effort))
    got = dt.encode_stream_gops(frames, meta, _crf(effort, dt.EncoderConfig),
                                device="cpu")
    assert got == want


def test_sequential_encoder_effort_matches_jax():
    """The sequential Encoder at effort 2 (HME at B = 1), and its state
    resumed from the JAX Encoder's state_dict halfway through."""
    frames, meta = _clip(8), Metadata(W, H, SUBSAMP_420)
    jenc = JEncoder(meta, _crf(2))
    jenc.start()
    want = b"".join(b"".join(jenc.encode(f)) for f in frames[:5])
    tenc = dt.Encoder(meta, _crf(2, dt.EncoderConfig), device="cpu")
    tenc.start()
    got = b"".join(b"".join(tenc.encode(f)) for f in frames[:5])
    assert got == want
    resumed = dt.Encoder(meta, _crf(2, dt.EncoderConfig), device="cpu")
    resumed.load_state_dict(jenc.state_dict())
    for f in frames[5:]:
        assert b"".join(resumed.encode(f)) == b"".join(jenc.encode(f))
    assert resumed.end_of_stream() == jenc.end_of_stream()


@pytest.mark.parametrize("extra", [
    ["-effort1"],                                   # per-frame ABR
    pytest.param(["-gopabr1", "-effort1"], marks=pytest.mark.slow),
    pytest.param(["-gopar0", "-effort3"], marks=pytest.mark.slow)])
def test_cli_effort_matches_jax(tmp_path, extra):
    """The CLI's stream and decode at effort 1 (defaults: per-frame ABR,
    gop 12), under -gopabr1, and at effort 3 on the sequential Encoder."""
    _cli_matches_jax(tmp_path, 2, extra, [])


@pytest.mark.parametrize("effort", [0, 2])
def test_decoders_match_encoder_recon(effort):
    """The last picture of both decoders (the sequential `Decoder` and
    `iter_decode_gops`) equals the sequential Encoder's reconstruction
    of it, the reference its next frame would have predicted from."""
    frames, meta = _clip(6), Metadata(W, H, SUBSAMP_420)
    enc = dt.Encoder(meta, _crf(effort, dt.EncoderConfig), device="cpu")
    enc.start()
    stream = enc.encode_stream(frames)
    lay = tfr.make_layout(SUBSAMP_420, W, H, True)
    recon = torch.from_numpy(enc.state_dict()["ref_recon"])
    want = [tfr.plane_view(recon, lay, c).numpy() for c in range(3)]
    for dec in (list(dt.Decoder(device="cpu").decode_stream(stream)),
                list(dt.iter_decode_gops(stream, device="cpu"))):
        fno, last = dec[-1]
        assert fno == len(frames) - 1
        for a, b in zip(last, want):
            np.testing.assert_array_equal(a, b)
