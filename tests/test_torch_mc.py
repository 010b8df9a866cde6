"""PyTorch port vs JAX: motion-compensated prediction.

The port predicts all three planes of a frame at once
(`bmc.compensate_frame`); on the CPU it takes the plain version of its
CUDA kernel (dsv1_tpu_torch/ops/mc.py), which filters each block's flat
neighbourhood for its half-pel phase. Each plane is held against the
JAX XLA form (`compensate_plane(pallas_ok=False)`, whole-image half-pel
variants) and against the Pallas `_mc_kernel` run in interpret mode,
with the fuzz of test_pallas_mc.py: random modes, MVs far past the plane
edges, random submasks; in 4:2:0 and 4:4:4, and on a layout without
guard margins, where the filter taps reach past both ends of the flat
image."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsv1_tpu.constants import SUBSAMP_420, SUBSAMP_444
from dsv1_tpu.ops import bmc as jbmc, frame as jfr, pallas_mc
from dsv1_tpu_torch.ops import bmc as tbmc, frame as tfr, mc as tmc

from . import corpus

torch.set_num_threads(1)


def _frame(w, h, subsamp, seed, margin=None, planes=None):
    """(JAX layout, JAX image, port layout, port image, planes) of one
    clip frame, or of the given planes; margin overrides the layouts'
    guard margin."""
    layout = jfr.make_layout(subsamp, w, h, True)
    tl = tfr.make_layout(subsamp, w, h, True)
    if margin is not None:
        layout = dataclasses.replace(layout, margin=margin)
        tl = dataclasses.replace(tl, margin=margin)
    if planes is None:
        yuv = corpus.make_clip(w, h, subsamp, 1, seed=seed)
        cw, ch = layout.planes[1].w, layout.planes[1].h
        planes = jfr.np_yuv_split(
            np.frombuffer(yuv[:w * h + 2 * cw * ch], np.uint8), subsamp, w,
            h)
    img = jfr.image_from_planes(layout, [jnp.asarray(p) for p in planes])
    return layout, img, tl, torch.from_numpy(np.asarray(img)), planes


def _fuzz(rng, nblk, w, h):
    """Random modes, MVs up to twice the frame past its edges, submasks."""
    return (rng.integers(0, 2, nblk).astype(np.int32),
            rng.integers(-2 * w, 2 * w, nblk).astype(np.int32),
            rng.integers(-2 * h, 2 * h, nblk).astype(np.int32),
            rng.integers(0, 16, nblk).astype(np.int32))


def _check_planes(layout, img, tl, timg, blk, nbh, nbv, fields, planes_c,
                  pallas=True):
    """compensate_frame's planes against JAX compensate_plane (XLA form
    and, with pallas, the Pallas kernel in interpret mode)."""
    got = tbmc.compensate_frame(timg, tl, blk, blk, nbh, nbv,
                                *[torch.from_numpy(a) for a in fields])
    for c in planes_c:
        args = (img, jfr.plane_view(img, layout, c), layout, c, blk, blk,
                nbh, nbv, *[jnp.asarray(a) for a in fields])
        want = np.asarray(jbmc.compensate_plane(*args, pallas_ok=False))
        np.testing.assert_array_equal(got[c].numpy(), want,
                                      err_msg=f"plane {c} vs XLA")
        if pallas:
            np.testing.assert_array_equal(
                got[c].numpy(),
                np.asarray(jbmc.compensate_plane(*args, pallas_ok=True)),
                err_msg=f"plane {c} vs Pallas")
    return got


@pytest.mark.parametrize("w,h,seed", [(96, 80, 0), (100, 84, 1),
                                      (96, 88, 2)])
@pytest.mark.parametrize("c", [0, 1, 2])
def test_mc_matches_jax(w, h, seed, c, monkeypatch):
    monkeypatch.setattr(pallas_mc, "INTERPRET", True)
    blk = 16
    nbh, nbv = -(-w // blk), -(-h // blk)
    rng = np.random.default_rng(seed)
    layout, img, tl, timg, planes = _frame(w, h, SUBSAMP_420, seed)
    fields = _fuzz(rng, nbh * nbv, w, h)
    got = _check_planes(layout, img, tl, timg, blk, nbh, nbv, fields,
                        [c])[c].numpy()

    # the residual helpers on the same plane
    src = np.asarray(planes[c])
    np.testing.assert_array_equal(
        tbmc.sub_residual(torch.from_numpy(src),
                          torch.from_numpy(got)).numpy(),
        np.asarray(jbmc.sub_residual(jnp.asarray(src), jnp.asarray(got))))
    np.testing.assert_array_equal(
        tbmc.add_residual(torch.from_numpy(got),
                          torch.from_numpy(src)).numpy(),
        np.asarray(jbmc.add_residual(jnp.asarray(got), jnp.asarray(src))))


@pytest.mark.parametrize("subsamp", [SUBSAMP_420, SUBSAMP_444])
@pytest.mark.parametrize("w,h,blk,seed", [(100, 84, 16, 3), (72, 56, 24, 4)])
def test_compensate_frame_matches_jax(subsamp, w, h, blk, seed,
                                      monkeypatch):
    """All three planes of one call, each with the fuzzed field."""
    monkeypatch.setattr(pallas_mc, "INTERPRET", True)
    nbh, nbv = -(-w // blk), -(-h // blk)
    layout, img, tl, timg, _ = _frame(w, h, subsamp, seed)
    fields = _fuzz(np.random.default_rng(seed), nbh * nbv, w, h)
    got = _check_planes(layout, img, tl, timg, blk, nbh, nbv, fields,
                        range(3))
    # one buffer, three (h, w) views in plane order
    assert got[1].untyped_storage().data_ptr() \
        == got[0].untyped_storage().data_ptr()
    assert [tuple(g.shape) for g in got] == \
        [(p.h, p.w) for p in tl.planes]


@pytest.mark.parametrize("subsamp,w", [(SUBSAMP_420, 256),
                                       (SUBSAMP_444, 128)])
def test_compensate_frame_taps_past_image_ends(subsamp, w):
    """No guard margin: inter blocks whose MVs point far past a corner
    clamp to that corner of the extended planes. At the top of plane 0
    the luma taps read flat indices < 0, which must read 0, and the
    diagonal's horizontal intermediates at indices < 0 must be 0 too,
    not 4-taps of zeros and the image's first byte: with a luma stride
    of exactly w + 128 (a 128 wide plane, no zero tail) the top-right
    window's touch that byte. (At the bottom of the last plane the
    window clamps one row short of the end, so its chroma taps stay
    below n.) The first byte is 200 on mid-grey noise, so that a wrong
    tap or intermediate moves the rounded value without saturating it."""
    h, blk = 48, 16
    nbh, nbv = w // blk, h // blk
    nblk = nbh * nbv
    rng = np.random.default_rng(7)
    geo = tfr.make_layout(subsamp, w, h, True).planes
    planes = [rng.integers(32, 224, (p.h, p.w)).astype(np.uint8)
              for p in geo]
    planes[0][0, 0] = 200
    layout, img, tl, timg, _ = _frame(w, h, subsamp, 5, margin=0,
                                      planes=planes)
    # every block to one of the four corners, odd and even MVs
    sx = np.where(np.arange(nblk) % 2, 1, -1).astype(np.int32)
    sy = np.where(np.arange(nblk) // 2 % 2, 1, -1).astype(np.int32)
    mvx = (sx * (8 * w + rng.choice([1, 3], nblk))).astype(np.int32)
    mvy = (sy * (8 * h + rng.choice([1, 3], nblk))).astype(np.int32)
    fields = (np.zeros(nblk, np.int32), mvx, mvy, np.zeros(nblk, np.int32))
    assert tmc.frame_geometry(tl, blk, blk)[0][0].start == 0  # row -1: < 0
    _check_planes(layout, img, tl, timg, blk, nbh, nbv, fields, range(3),
                  pallas=False)
