"""PyTorch port vs JAX: motion-compensated prediction.

The port's MC path on the CPU takes the plain version of its CUDA kernel
(dsv1_tpu_torch/ops/mc.py). It is held against the JAX XLA form
(`compensate_plane(pallas_ok=False)`) and against the Pallas `_mc_kernel`
run in interpret mode, with the fuzz of test_pallas_mc.py: random modes,
MVs far past the plane edges, random submasks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsv1_tpu.constants import SUBSAMP_420
from dsv1_tpu.ops import bmc as jbmc, frame as jfr, pallas_mc
from dsv1_tpu_torch.ops import bmc as tbmc, frame as tfr

from . import corpus

torch.set_num_threads(1)


@pytest.mark.parametrize("w,h,seed", [(96, 80, 0), (100, 84, 1),
                                      (96, 88, 2)])
@pytest.mark.parametrize("c", [0, 1])
def test_mc_matches_jax(w, h, seed, c, monkeypatch):
    monkeypatch.setattr(pallas_mc, "INTERPRET", True)
    blk = 16
    nbh, nbv = -(-w // blk), -(-h // blk)
    nblk = nbh * nbv
    rng = np.random.default_rng(seed)
    yuv = corpus.make_clip(w, h, SUBSAMP_420, 1, seed=seed)
    fsz = w * h + 2 * (w // 2) * (h // 2)
    planes = jfr.np_yuv_split(np.frombuffer(yuv[:fsz], np.uint8),
                              SUBSAMP_420, w, h)
    layout = jfr.make_layout(SUBSAMP_420, w, h, True)
    img = jfr.image_from_planes(layout, [jnp.asarray(p) for p in planes])
    modes = rng.integers(0, 2, nblk).astype(np.int32)
    mvx = rng.integers(-2 * w, 2 * w, nblk).astype(np.int32)
    mvy = rng.integers(-2 * h, 2 * h, nblk).astype(np.int32)
    sub = rng.integers(0, 16, nblk).astype(np.int32)
    args = (img, jfr.plane_view(img, layout, c), layout, c, blk, blk, nbh,
            nbv, jnp.asarray(modes), jnp.asarray(mvx), jnp.asarray(mvy),
            jnp.asarray(sub))
    xla = np.asarray(jbmc.compensate_plane(*args, pallas_ok=False))
    pallas = np.asarray(jbmc.compensate_plane(*args, pallas_ok=True))

    tl = tfr.make_layout(SUBSAMP_420, w, h, True)
    got = tbmc.compensate_plane(
        torch.from_numpy(np.asarray(img)), tl, c, blk, blk, nbh, nbv,
        *[torch.from_numpy(a) for a in (modes, mvx, mvy, sub)]).numpy()
    np.testing.assert_array_equal(got, xla)
    np.testing.assert_array_equal(got, pallas)

    # half-pel variants and the residual helpers on the same plane
    hp = (jbmc.hpel_variants_luma if c == 0 else jbmc.hpel_variants_chroma)
    thp = (tbmc.hpel_variants_luma if c == 0
           else tbmc.hpel_variants_chroma)
    np.testing.assert_array_equal(
        thp(torch.from_numpy(np.asarray(img)), tl, c).numpy(),
        np.asarray(hp(img, layout, c)))
    src = np.asarray(planes[c])
    np.testing.assert_array_equal(
        tbmc.sub_residual(torch.from_numpy(src),
                          torch.from_numpy(got)).numpy(),
        np.asarray(jbmc.sub_residual(jnp.asarray(src), jnp.asarray(got))))
    np.testing.assert_array_equal(
        tbmc.add_residual(torch.from_numpy(got),
                          torch.from_numpy(src)).numpy(),
        np.asarray(jbmc.add_residual(jnp.asarray(got), jnp.asarray(src))))
