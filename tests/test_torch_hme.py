"""PyTorch port vs JAX: hierarchical motion estimation.

- The plain versions of the port's two HME kernels against the Pallas
  `_refine_kernel` / `_base_kernel` in interpret mode, on random
  candidate fields (far, invalid and duplicate MVs included). The base
  kernel is held against both of its Pallas forms: the resident one and
  the banded one that the JAX package runs on 4K planes (SRC streamed
  per block row, `_build_base_call_banded`), which the port's single
  `hme_base` kernel also serves. One case of each runs in tier-1 (the
  base kernel's in both forms, on a plane with a partial bottom block
  row), the rest are `slow`.
- The level-0 candidates of `refine_coarse` (every coarse level and the
  candidate construction between them) against the JAX package's own
  coarse loop run through the Pallas `_refine_kernel` in interpret mode
  (one case in tier-1, 3 levels, 2 levels and none `slow`).
- The port's `hme_batch` against the JAX XLA `hme()` on the geometries
  of test_hme.py (partial right column and bottom row included).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsv1_tpu.constants import SUBSAMP_420, round_shift
from dsv1_tpu.ops import frame as jfr, hme as jhme, pallas_hme
from dsv1_tpu_torch.ops import frame as tfr, hme as thme, hme_kernels as hk

from . import corpus

torch.set_num_threads(1)

LEVELS, BLK = 3, 16


def _frames(w, h, seed, shift):
    yuv = corpus.make_clip(w, h, SUBSAMP_420, 2, seed=seed)
    fsz = w * h + 2 * (w // 2) * (h // 2)
    f0 = jfr.np_yuv_split(np.frombuffer(yuv[:fsz], np.uint8), SUBSAMP_420,
                          w, h)
    f1 = jfr.np_yuv_split(np.frombuffer(yuv[fsz:2 * fsz], np.uint8).copy(),
                          SUBSAMP_420, w, h)
    if shift:
        f1 = (np.roll(f0[0], shift, axis=1), f0[1], f0[2])
    return f1, f0


def _pyramid(planes, w, h):
    """JAX flat images per level (level 0 the full frame) + layouts."""
    layouts = [jfr.make_layout(SUBSAMP_420, w, h, True)]
    imgs = [jfr.image_from_planes(layouts[0],
                                  [jnp.asarray(p) for p in planes])]
    for i in range(LEVELS):
        pw, ph = round_shift(w, i + 1), round_shift(h, i + 1)
        lay = jfr.make_layout(SUBSAMP_420, pw, ph, True)
        luma = jfr.ds2x_luma(jfr.plane_view_ext(imgs[-1], layouts[-1], 0, 1),
                             pw, ph)
        imgs.append(jfr.image_from_luma(lay, luma))
        layouts.append(lay)
    return imgs, layouts


def _planes2d(w, h, level, seeds):
    """(B, EH, S) extended luma planes (JAX arrays) at one level for B
    frame pairs, the level's layout, and the port's (B, n) flat images
    and layout."""
    srcs, refs = [], []
    for seed, shift in seeds:
        f1, f0 = _frames(w, h, seed, shift)
        si, lays = _pyramid(f1, w, h)
        ri, _ = _pyramid(f0, w, h)
        srcs.append(np.asarray(si[level]))
        refs.append(np.asarray(ri[level]))
    lay = lays[level]
    s2 = jhme._lvl2d(jnp.asarray(np.stack(srcs)), lay)
    r2 = jhme._lvl2d(jnp.asarray(np.stack(refs)), lay)
    return s2, r2, lay, (_t(np.stack(srcs)), _t(np.stack(refs)),
                         tfr.make_layout(SUBSAMP_420, lay.width, lay.height,
                                         True))


def _cands(rng, B, nb, nc, w, h):
    cm = rng.integers(-3 * w, 3 * w, (B, nb, 2 * nc)).astype(np.int32)
    cm[:, :, nc:] = rng.integers(-3 * h, 3 * h, (B, nb, nc))
    small = rng.random((B, nb, 2 * nc)) < 0.6   # mostly near-zero MVs
    cm = np.where(small, rng.integers(-9, 10, cm.shape), cm)
    cm[:, :, 0] = cm[:, :, nc] = 0               # slot 0: the zero MV
    if nc > 2:
        cm[:, 1::3, 2] = cm[:, 1::3, 1]          # duplicate candidates
    return cm[..., :nc], cm[..., nc:]


def _t(a):
    return torch.from_numpy(np.array(a))


LEVEL_CASES = [
    pytest.param(96, 80, 1, 6, 0),
    pytest.param(100, 84, 2, 6, 1, marks=pytest.mark.slow),
    pytest.param(96, 88, 3, 1, 2, marks=pytest.mark.slow),
]


@pytest.mark.parametrize("w,h,level,nc,seed", LEVEL_CASES)
def test_refine_level_plain_matches_pallas(w, h, level, nc, seed):
    s2, r2, lay, flats = _planes2d(w, h, level,
                                   [(seed + 1, 3), (seed + 2, 0)])
    step = 1 << level
    nbh_l = len(range(0, -(-w // BLK), step))
    nb = nbh_l * len(range(0, -(-h // BLK), step))
    cmx, cmy = _cands(np.random.default_rng(seed), 2, nb, nc, w, h)
    want = pallas_hme.refine_level_pallas(
        s2, r2, jnp.asarray(cmx), jnp.asarray(cmy), lay, level, BLK, BLK,
        nbh_l, nb, interpret=True)
    got = hk.refine_level(*flats, _t(cmx), _t(cmy), nbh_l, nb, BLK, BLK,
                          level)
    for g, e in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))


BASE_CASES = [
    pytest.param(100, 84, 3, 2, False),
    pytest.param(100, 84, 3, 2, True),     # partial bottom and right blocks
    pytest.param(96, 80, 4, 11, False, marks=pytest.mark.slow),
    pytest.param(96, 80, 4, 11, True, marks=pytest.mark.slow),
    pytest.param(96, 88, 5, 5, False, marks=pytest.mark.slow),
    pytest.param(104, 90, 6, 7, True, marks=pytest.mark.slow),
]


@pytest.mark.parametrize("w,h,seed,shift,banded", BASE_CASES)
def test_refine_base_plain_matches_pallas(w, h, seed, shift, banded):
    s2, r2, lay, flats = _planes2d(w, h, 0, [(seed, shift), (seed + 7, 0)])
    nbh = -(-w // BLK)
    nb = nbh * -(-h // BLK)
    cmx, cmy = _cands(np.random.default_rng(seed), 2, nb, 6, w, h)
    want = pallas_hme.refine_base_pallas(
        s2, r2, jnp.asarray(cmx), jnp.asarray(cmy), lay, BLK, BLK, nbh, nb,
        interpret=True, banded=banded)
    got = hk.refine_base(*flats, _t(cmx), _t(cmy), nbh, nb, BLK, BLK)
    for name, g, e in zip(("mvx", "mvy", "flags", "qbits", "luma_tex",
                           "src_var"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e),
                                      err_msg=name)


def _jax_coarse_cands(s2, r2, lays, nbh, nbv, levels):
    """The coarse loop of the JAX package's hme_batch (hme.py:731-767)
    on per-level (B, EH, S) planes, through the Pallas refine kernel in
    interpret mode: the level-0 candidates as (B, nb, 2 NC)."""
    mvf = None
    for level in range(levels, 0, -1):
        lay = lays[level]
        step, ii, jj = jhme._lvl_grid(level, nbh, nbv)
        nbh_l, nbv_l = len(ii), len(jj)
        nb = nbh_l * nbv_l
        B = s2[level].shape[0]
        if mvf is None:
            cmx = cmy = jnp.zeros((B, nb, 1), jnp.int32)
        else:
            cmx, cmy = jhme._build_cands_batched(level, mvf, nbh, nbv)
        dx, dy, _ = pallas_hme.refine_level_pallas(
            s2[level], r2[level], cmx, cmy, lay, level, BLK, BLK, nbh_l, nb,
            interpret=True)
        p = lay.planes[0]
        infr = jnp.asarray((((ii * BLK) >> level)[None, :] < p.w)
                           & (((jj * BLK) >> level)[:, None] < p.h)) \
            .reshape(-1)
        field = jnp.stack([jnp.where(infr[None, :], dx << level, 0),
                           jnp.where(infr[None, :], dy << level, 0)], -1)
        mvf = jnp.zeros((B, nbv, nbh, 2), jnp.int32) \
            .at[:, ::step, ::step].set(field.reshape(B, nbv_l, nbh_l, 2))
    if mvf is None:
        cmx = cmy = jnp.zeros((s2[0].shape[0], nbh * nbv, 1), jnp.int32)
    else:
        cmx, cmy = jhme._build_cands_batched(0, mvf, nbh, nbv)
    return np.concatenate([np.asarray(cmx), np.asarray(cmy)], -1)


COARSE_CASES = [
    pytest.param(96, 80, [(1, 3)], LEVELS),
    pytest.param(100, 84, [(2, 0), (3, 5)], LEVELS, marks=pytest.mark.slow),
    pytest.param(96, 88, [(4, 11)], 2, marks=pytest.mark.slow),
    pytest.param(96, 80, [(5, 2)], 0, marks=pytest.mark.slow),
]


@pytest.mark.parametrize("w,h,seeds,levels", COARSE_CASES)
def test_refine_coarse_plain_matches_pallas(w, h, seeds, levels):
    srcs, refs = [], []
    for seed, shift in seeds:
        f1, f0 = _frames(w, h, seed, shift)
        si, lays = _pyramid(f1, w, h)
        ri, _ = _pyramid(f0, w, h)
        srcs.append(si)
        refs.append(ri)
    s2 = [jhme._lvl2d(jnp.stack([s[lv] for s in srcs]), lay)
          for lv, lay in enumerate(lays)]
    r2 = [jhme._lvl2d(jnp.stack([r[lv] for r in refs]), lay)
          for lv, lay in enumerate(lays)]
    nbh, nbv = -(-w // BLK), -(-h // BLK)
    want = _jax_coarse_cands(s2, r2, lays, nbh, nbv, levels)
    tl = [tfr.make_layout(SUBSAMP_420, lay.width, lay.height, True)
          for lay in lays]
    got = hk.refine_coarse([_t(np.stack([s[lv] for s in srcs]))
                            for lv in range(len(lays))],
                           [_t(np.stack([r[lv] for r in refs]))
                            for lv in range(len(lays))], tl,
                           BLK, BLK, nbh, nbv, levels)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed,shift,w,h", [
    (1, 3, 96, 80), (2, 0, 96, 80), (5, 11, 96, 80),
    (3, 2, 100, 84), (4, 5, 96, 88),
])
def test_hme_batch_matches_xla_hme(seed, shift, w, h):
    f1, f0 = _frames(w, h, seed, shift)
    si, lays = _pyramid(f1, w, h)
    ri, _ = _pyramid(f0, w, h)
    nbh, nbv = -(-w // BLK), -(-h // BLK)
    want = jhme.hme(si, ri, lays, BLK, BLK, nbh, nbv, SUBSAMP_420, LEVELS)
    tl = [tfr.make_layout(SUBSAMP_420, lay.width, lay.height, True)
          for lay in lays]
    got = thme.hme_batch([_t(a)[None] for a in si], [_t(a)[None] for a in ri],
                         tl, BLK, BLK, nbh, nbv, SUBSAMP_420, LEVELS)
    for key in ("mode", "mvx", "mvy", "submask", "lo_tex", "lo_var",
                "high_detail"):
        np.testing.assert_array_equal(got[key][0].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    assert int(got["intra_pct"][0]) == int(want["intra_pct"])
