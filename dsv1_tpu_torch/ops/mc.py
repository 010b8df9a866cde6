"""Motion-compensated prediction of a frame: CUDA kernel + plain version.

Replaces the Pallas kernel `_mc_kernel` (dsv1_tpu/ops/pallas_mc.py:38)
and the whole-image half-pel variant build that feeds it in the JAX
package (dsv1_tpu/ops/bmc.py hpel_variants_*). For each motion block of
each plane (reference compensate, bmc.c:204-302): the clamped window
origin and half-pel phase from the block's raw MV, then either the BH x
BW inter window filtered for that phase (luma 4-tap, chroma bilinear)
or an intra fill from the zero-MV window (full-block DC when submask is
15, else a quadrant DC per set bit, 0 outside the sub-area, else the
zero-MV pixel), selected by mode.

The filters are the JAX package's whole-image flat-index filters,
evaluated only on each block's neighbourhood: a tap is a flat index
into the whole image of all planes (it crosses row and plane edges as
the reference's single allocation does), 0 outside [0, n), and the
luma diagonal's horizontal intermediate is itself 0 outside [0, n).

`predict_frame` takes the plain version for CPU tensors and launches
the kernel (csrc/mc.cu, one launch for the three planes of a batch of
frames) for CUDA tensors; there is no fallback.
"""

import ctypes
from dataclasses import dataclass
from functools import lru_cache

import torch

from ..constants import (FRAME_BORDER, MASK_ALL_INTRA, MAX_BLOCK_SIZE,
                         MODE_INTER, format_h_shift, format_v_shift)

from .frame import FrameLayout, flat_base, flat_windows


@dataclass(frozen=True)
class MCPlane:
    """Plane c's extended (EH, S) region in the flat image, its (h, w)
    prediction's offset in the frame's output, its block size and chroma
    shifts."""
    start: int   # flat index of the extended plane's (0, 0)
    out_off: int
    EH: int
    S: int
    E: int       # border
    w: int
    h: int
    BW: int
    BH: int
    sh: int
    sv: int


@lru_cache(maxsize=32)
def frame_geometry(layout: FrameLayout, blk_w: int, blk_h: int):
    """The three planes' MCPlane and the frame's output size."""
    if not 0 < blk_w <= MAX_BLOCK_SIZE or not 0 < blk_h <= MAX_BLOCK_SIZE:
        raise ValueError("block size out of range")
    planes, off = [], 0
    for c in range(3):
        p = layout.planes[c]
        sh = 0 if c == 0 else format_h_shift(layout.subsamp)
        sv = 0 if c == 0 else format_v_shift(layout.subsamp)
        planes.append(MCPlane(
            start=flat_base(layout, c) - p.ext * p.stride - p.ext,
            out_off=off, EH=p.h + 2 * p.ext, S=p.stride, E=p.ext, w=p.w,
            h=p.h, BW=blk_w >> sh, BH=blk_h >> sv, sh=sh, sv=sv))
        off += p.h * p.w
    return tuple(planes), off


@lru_cache(maxsize=32)
def _geo_array(layout: FrameLayout, blk_w: int, blk_h: int):
    """The kernel's host geometry array (csrc/mc.cu dsv1_mc_frame)."""
    planes, _ = frame_geometry(layout, blk_w, blk_h)
    vals = [v for g in planes for v in (g.start, g.out_off, g.EH, g.S, g.E,
                                        g.w, g.h, g.BW, g.BH, g.sh, g.sv)]
    return (ctypes.c_int64 * 35)(*vals, FRAME_BORDER, MODE_INTER)


def _plane_plain(img, g: MCPlane, luma: bool, nbh: int, nbv: int, modes,
                 mvx, mvy, sub):
    """One plane's (h, w) u8 prediction, per block as the kernel does it:
    gather the flat neighbourhood with the same zero rules, filter it
    for the block's phase, fill intra blocks, select."""
    dev, n = img.device, img.shape[-1]
    BW, BH, S = g.BW, g.BH, g.S
    nblk = nbh * nbv
    bx = (torch.arange(nbh, device=dev) * BW).repeat(nbv)
    by = (torch.arange(nbv, device=dev) * BH).repeat_interleave(nbh)
    bw_c = (g.w - bx).clamp(0, BW)[:, None, None]
    bh_c = (g.h - by).clamp(0, BH)[:, None, None]

    # inter: origin and phase from the raw MV, then the neighbourhood,
    # 0 outside [0, n): luma rows -1..BH+1 x flat span -1..BW+1, chroma
    # rows 0..BH x span 0..BW
    dx2, dy2 = mvx >> g.sh, mvy >> g.sv
    px = torch.clamp(bx + (dx2 >> 1), -FRAME_BORDER,
                     g.w - BW + FRAME_BORDER - 1)
    py = torch.clamp(by + (dy2 >> 1), -FRAME_BORDER,
                     g.h - BH + FRAME_BORDER - 1)
    phase = ((dx2 & 1) << 1) | (dy2 & 1)
    j0 = (g.start + (py + g.E).clamp(0, g.EH - BH).to(torch.int64) * S
          + (px + g.E).clamp(0, S - BW))
    lo, hi = (1, 2) if luma else (0, 1)
    rows = torch.arange(-lo, BH + hi, device=dev)
    cols = torch.arange(-lo, BW + hi, device=dev)
    j = j0[:, None, None] + rows[None, :, None] * S + cols[None, None, :]
    inside = (j >= 0) & (j < n)
    a = torch.where(inside, img[j.clamp(0, n - 1)].to(torch.int32), 0)

    def A(dr, dq):
        return a[:, lo + dr:lo + dr + BH, lo + dq:lo + dq + BW]

    if luma:
        v = ((9 * (A(0, 0) + A(1, 0)) - (A(-1, 0) + A(2, 0)) + 8) >> 4) \
            .clamp(0, 255)
        h = ((9 * (A(0, 0) + A(0, 1)) - (A(0, -1) + A(0, 2)) + 8) >> 4) \
            .clamp(0, 255)
        hu = 9 * (a[:, :, 1:1 + BW] + a[:, :, 2:2 + BW]) \
            - (a[:, :, 0:BW] + a[:, :, 3:3 + BW])
        hu = torch.where(inside[:, :, 1:1 + BW], hu, 0)

        def HU(dr):
            return hu[:, 1 + dr:1 + dr + BH]

        d = ((9 * (HU(0) + HU(1)) - (HU(-1) + HU(2)) + 128) >> 8) \
            .clamp(0, 255)
        variants = (A(0, 0), v, h, d)
    else:
        variants = (A(0, 0), (A(0, 0) + A(1, 0) + 1) >> 1,
                    (A(0, 0) + A(0, 1) + 1) >> 1,
                    (A(0, 0) + A(0, 1) + A(1, 0) + A(1, 1) + 2) >> 2)
    inter_val = torch.stack(variants)[phase.to(torch.int64),
                                      torch.arange(nblk, device=dev)]

    # intra: sums over the zero-MV window at the kernel's clamped origin
    zr = (g.E + by).clamp(0, (g.EH - BH) & ~7)
    zc = (g.E + bx).clamp(0, S - BW)
    z = flat_windows(img, g.start + zr * S + zc, BH, BW, S).to(torch.int32)
    r = torch.arange(BH, device=dev)[None, :, None]
    q = torch.arange(BW, device=dev)[None, None, :]
    inb = (r < bh_c) & (q < bw_c)
    sbw, sbh = bw_c // 2, bh_c // 2
    qx, qy = (q >= sbw).to(torch.int32), (r >= sbh).to(torch.int32)
    in_quad = (q - qx * sbw < sbw) & (r - qy * sbh < sbh)
    qi = qy * 2 + qx
    avg_full = (z * inb).sum((1, 2), keepdim=True) \
        // (bw_c * bh_c).clamp(min=1)
    sarea = (sbw * sbh).clamp(min=1)
    quad_avg = torch.zeros_like(z)
    for k in range(4):
        m = inb & in_quad & (qi == k)
        quad_avg = torch.where(qi == k, (z * m).sum((1, 2), keepdim=True)
                               // sarea, quad_avg)
    sb = sub[:, None, None]
    in_sub = in_quad & (sbw > 0) & (sbh > 0)
    intra_val = torch.where(
        sb == MASK_ALL_INTRA, avg_full,
        torch.where(~in_sub, 0,
                    torch.where(((sb >> qi) & 1) == 1, quad_avg, z)))
    pred = torch.where((modes == MODE_INTER)[:, None, None], inter_val,
                       intra_val).to(torch.uint8)
    return pred.reshape(nbv, nbh, BH, BW).permute(0, 2, 1, 3) \
        .reshape(nbv * BH, nbh * BW)[:g.h, :g.w]


def _batched(img, fields, nbh: int, nbv: int):
    """(images (C, n), fields (C, nbh * nbv) each) of a frame (n,) or a
    batch (C, n), and whether a batch was given."""
    batch = img.dim() == 2
    imgs = img if batch else img[None]
    f = [x.reshape(imgs.shape[0], -1) for x in fields]
    if any(x.shape[1] != nbh * nbv for x in f):
        raise ValueError("per-block field has the wrong size")
    return imgs, f, batch


def predict_frame_plain(img, layout: FrameLayout, blk_w: int, blk_h: int,
                        nbh: int, nbv: int, modes, mvx, mvy, submask):
    """The plain version of predict_frame, frame by frame."""
    planes, size = frame_geometry(layout, blk_w, blk_h)
    imgs, f, batch = _batched(img, (modes, mvx, mvy, submask), nbh, nbv)
    out = torch.empty((imgs.shape[0], size), dtype=torch.uint8,
                      device=img.device)
    for z in range(imgs.shape[0]):
        fz = [x[z].to(torch.int32) for x in f]
        for c, g in enumerate(planes):
            out[z, g.out_off:g.out_off + g.h * g.w] = _plane_plain(
                imgs[z], g, c == 0, nbh, nbv, *fz).reshape(-1)
    return out if batch else out[0]


def predict_frame(img, layout: FrameLayout, blk_w: int, blk_h: int,
                  nbh: int, nbv: int, modes, mvx, mvy, submask):
    """The three planes' predictions back to back, (sum of h * w,) u8,
    from the flat extended reference image (n,) and the per-block mode,
    MV and submask fields (nbv * nbh each); for a batch of C frames,
    images (C, n) and fields (C, ...) give (C, sum of h * w): the plain
    version on CPU tensors, one launch of csrc/mc.cu for the whole batch
    on CUDA tensors."""
    if not img.is_cuda:
        return predict_frame_plain(img, layout, blk_w, blk_h, nbh, nbv,
                                   modes, mvx, mvy, submask)
    from ..kernels.build import LAUNCHES, launch
    if img.dtype != torch.uint8 or img.dim() not in (1, 2) \
            or img.stride(-1) != 1:
        raise ValueError("img must be a uint8 tensor (n,) or (C, n) with "
                         "contiguous rows")
    _, size = frame_geometry(layout, blk_w, blk_h)
    dev = img.device
    imgs, f, batch = _batched(img, (modes, mvx, mvy, submask), nbh, nbv)
    f = [x.to(device=dev, dtype=torch.int32) for x in f]
    if any(x.stride() != f[0].stride() or x.stride(1) != 1 for x in f):
        f = [x.contiguous() for x in f]
    C = imgs.shape[0]
    out = torch.empty((C, size), dtype=torch.uint8, device=dev)
    launch("dsv1_mc_frame", img, imgs.data_ptr(), imgs.shape[1],
           imgs.stride(0), _geo_array(layout, blk_w, blk_h), nbh, nbv,
           f[0].data_ptr(), f[1].data_ptr(), f[2].data_ptr(),
           f[3].data_ptr(), f[0].stride(0), out.data_ptr(), size, C)
    LAUNCHES["mc"] += 1
    return out if batch else out[0]
