"""Block motion compensation (mirror of dsv1_tpu/ops/bmc.py).

The half-pel filters (luma 4-tap 9*(p0+p1)-(p-1+p2), chroma bilinear;
reference bmc.c:57-174) are position-invariant, so all four phase
variants are computed over the whole flat image once, in flat index
space: a tap that crosses a row or plane edge reads the same byte as in
the reference's single allocation. The per-block prediction build runs
in ops/mc.py (the MC kernel on CUDA).
"""

import torch
import torch.nn.functional as F

from ..constants import FRAME_BORDER, MODE_INTER, format_h_shift, \
    format_v_shift

from . import mc
from .frame import FrameLayout, flat_base


def _shifts(img, pad: int):
    """a(k) = img[i + k] as int32, zero outside the image."""
    n = img.shape[-1]
    ap = F.pad(img.to(torch.int32), (pad, pad))
    return lambda k: ap[..., pad + k:pad + k + n]


def hpel_variants_luma(img, layout: FrameLayout, c: int):
    """D.1.1 luma half-pel filter over the whole flat image: (4n,) u8,
    phase (xh << 1) | yh as in bmc.c:124-174."""
    s = layout.planes[c].stride
    a = _shifts(img, 2 * s + 2)
    a0 = a(0)
    hu = 9 * (a0 + a(1)) - (a(-1) + a(2))
    h8 = ((hu + 8) >> 4).clamp(0, 255)
    vu = 9 * (a0 + a(s)) - (a(-s) + a(2 * s))
    v8 = ((vu + 8) >> 4).clamp(0, 255)
    # diagonal: vertical 4-tap over the unclamped horizontal values
    hp = _shifts(hu, 2 * s + 2)
    du = 9 * (hp(0) + hp(s)) - (hp(-s) + hp(2 * s))
    d8 = ((du + 128) >> 8).clamp(0, 255)
    return torch.cat([x.to(torch.uint8) for x in (a0, v8, h8, d8)], dim=-1)


def hpel_variants_chroma(img, layout: FrameLayout, c: int):
    """D.1.2 chroma half-pel (bilinear) over the whole image, 4 phases."""
    s = layout.planes[c].stride
    a = _shifts(img, s + 1)
    a0, ax, ay, axy = a(0), a(1), a(s), a(s + 1)
    v1 = (a0 + ay + 1) >> 1
    v2 = (a0 + ax + 1) >> 1
    v3 = (a0 + ax + ay + axy + 2) >> 2
    return torch.cat([x.to(torch.uint8) for x in (a0, v1, v2, v3)], dim=-1)


def mc_args(ref_img, layout: FrameLayout, c: int, blk_w: int, blk_h: int,
            nbh: int, nbv: int, modes, mvx, mvy, submask):
    """The arguments of mc.predict for plane c: the half-pel variants,
    the geometry, and per block the inter flag, submask, clamped
    (row, col) origin in the extended plane and the phase
    (bmc.c:204-302)."""
    p = layout.planes[c]
    sh = 0 if c == 0 else format_h_shift(layout.subsamp)
    sv = 0 if c == 0 else format_v_shift(layout.subsamp)
    bw, bh = blk_w >> sh, blk_h >> sv
    limx = (p.w - bw) + FRAME_BORDER - 1
    limy = (p.h - bh) + FRAME_BORDER - 1
    variants = (hpel_variants_luma if c == 0 else hpel_variants_chroma)(
        ref_img, layout, c)
    dev = ref_img.device
    dx2 = mvx.to(torch.int32).reshape(nbv, nbh) >> sh
    dy2 = mvy.to(torch.int32).reshape(nbv, nbh) >> sv
    px = (torch.arange(nbh, device=dev)[None, :] * bw + (dx2 >> 1)) \
        .clamp(-FRAME_BORDER, limx)
    py = (torch.arange(nbv, device=dev)[:, None] * bh + (dy2 >> 1)) \
        .clamp(-FRAME_BORDER, limy)
    phase = ((dx2 & 1) << 1) | (dy2 & 1)
    g = mc.MCGeom(n=ref_img.shape[-1],
                  start=flat_base(layout, c) - p.ext * p.stride - p.ext,
                  EH=p.h + 2 * p.ext, S=p.stride, E=p.ext, w=p.w, h=p.h,
                  BW=bw, BH=bh, nbh=nbh, nbv=nbv)
    inter = (modes.reshape(nbv, nbh) == MODE_INTER).to(torch.int32)
    return (variants, g, inter, submask.reshape(nbv, nbh).to(torch.int32),
            py + p.ext, px + p.ext, phase)


def compensate_plane(ref_img, layout: FrameLayout, c: int, blk_w: int,
                     blk_h: int, nbh: int, nbv: int, modes, mvx, mvy,
                     submask):
    """D.1/D.2 compensate (bmc.c:204-302): the (h, w) u8 prediction of
    plane c from the flat extended reference image."""
    return mc.predict(*mc_args(ref_img, layout, c, blk_w, blk_h, nbh, nbv,
                               modes, mvx, mvy, submask))


def add_residual(pred, dif):
    """addf (bmc.c:29-41): clamp(pred + dif - 128)."""
    v = pred.to(torch.int32) + dif.to(torch.int32) - 128
    return v.clamp(0, 255).to(torch.uint8)


def sub_residual(inp, pred):
    """subf (bmc.c:43-55): residual = clamp(inp - pred + 128)."""
    v = inp.to(torch.int32) - pred.to(torch.int32) + 128
    return v.clamp(0, 255).to(torch.uint8)
