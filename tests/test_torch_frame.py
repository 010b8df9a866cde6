"""PyTorch port vs JAX: frame layouts, images with borders, plane views,
packed-plane split, the luma pyramid downsample and the SCD average."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsv1_tpu.constants import (SUBSAMP_411, SUBSAMP_420, SUBSAMP_422,
                                SUBSAMP_444)
from dsv1_tpu.ops import frame as jfr
from dsv1_tpu_torch.ops import frame as tfr

torch.set_num_threads(1)

FORMATS = [SUBSAMP_444, SUBSAMP_422, SUBSAMP_420, SUBSAMP_411]


def _planes(rng, subsamp, w, h):
    _, _, cw, ch = jfr.plane_sizes(subsamp, w, h)
    return [rng.integers(0, 256, s, dtype=np.uint8)
            for s in ((h, w), (ch, cw), (ch, cw))]


@pytest.mark.parametrize("subsamp", FORMATS)
@pytest.mark.parametrize("w,h", [(96, 80), (101, 83), (17, 9)])
def test_layout_image_views(subsamp, w, h):
    rng = np.random.default_rng(w * 7 + h + subsamp)
    for border in (True, False):
        jl = jfr.make_layout(subsamp, w, h, border)
        tl = tfr.make_layout(subsamp, w, h, border)
        assert (jl.total, jl.margin) == (tl.total, tl.margin)
        for jp, tp in zip(jl.planes, tl.planes):
            assert (jp.offset, jp.stride, jp.w, jp.h, jp.ext) == \
                (tp.offset, tp.stride, tp.w, tp.h, tp.ext)
    jl = jfr.make_layout(subsamp, w, h, True)
    tl = tfr.make_layout(subsamp, w, h, True)
    planes = _planes(rng, subsamp, w, h)
    jimg = np.asarray(jfr.image_from_planes(jl, [jnp.asarray(p)
                                                 for p in planes]))
    timg = tfr.image_from_planes(tl, [torch.from_numpy(p) for p in planes])
    np.testing.assert_array_equal(timg.numpy(), jimg)
    for c in range(3):
        np.testing.assert_array_equal(
            tfr.plane_view(timg, tl, c).numpy(),
            np.asarray(jfr.plane_view(jnp.asarray(jimg), jl, c)))
        np.testing.assert_array_equal(
            tfr.plane_view_ext(timg, tl, c, 1).numpy(),
            np.asarray(jfr.plane_view_ext(jnp.asarray(jimg), jl, c, 1)))
    np.testing.assert_array_equal(
        tfr.image_from_luma(tl, torch.from_numpy(planes[0])).numpy(),
        np.asarray(jfr.image_from_luma(jl, jnp.asarray(planes[0]))))
    np.testing.assert_array_equal(tfr.alloc_image(tl, device="cpu").numpy(),
                                  np.asarray(jfr.alloc_image(jl)))


@pytest.mark.parametrize("subsamp", FORMATS)
def test_split_ds2x_avg_luma(subsamp):
    w, h = 101, 83
    rng = np.random.default_rng(subsamp)
    planes = _planes(rng, subsamp, w, h)
    packed = np.stack([jfr.np_pack_planes(planes),
                       jfr.np_pack_planes(_planes(rng, subsamp, w, h))])
    jy = jfr.split_packed_planes(jnp.asarray(packed), subsamp, w, h)
    ty = tfr.split_packed_planes(torch.from_numpy(packed), subsamp, w, h)
    for a, b in zip(ty, jy):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jl = jfr.make_layout(subsamp, w, h, True)
    tl = tfr.make_layout(subsamp, w, h, True)
    jimg = jfr.image_from_planes(jl, [jnp.asarray(p) for p in planes])
    timg = tfr.image_from_planes(tl, [torch.from_numpy(p) for p in planes])
    dw, dh = (w + 1) // 2, (h + 1) // 2
    jd = jfr.ds2x_luma(jfr.plane_view_ext(jimg, jl, 0, 1), dw, dh)
    td = tfr.ds2x_luma(tfr.plane_view_ext(timg, tl, 0, 1), dw, dh)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert int(tfr.avg_luma(td)) == int(jfr.avg_luma(jd))
    assert int(tfr.avg_luma(torch.from_numpy(planes[0]))) == \
        int(jfr.avg_luma(jnp.asarray(planes[0])))
