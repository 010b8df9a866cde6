"""Motion-compensated prediction build: CUDA kernel + plain PyTorch version.

Replaces the Pallas kernel `_mc_kernel` (dsv1_tpu/ops/pallas_mc.py:38).
For each motion block: the BH x BW inter window from one of the four
half-pel variant planes at a clamped origin, or an intra fill from the
zero-MV window (full-block DC when submask is 15, else a quadrant DC per
set bit, 0 outside the sub-area, else the zero-MV pixel), selected by
mode (reference compensate, bmc.c:204-302). The variant planes are
computed outside (ops/bmc.py), in flat image space.

The wrapper `predict` takes the plain version for CPU tensors and
launches the kernel (csrc/mc.cu) for CUDA tensors; there is no fallback.
"""

from dataclasses import dataclass

import torch

from ..constants import MASK_ALL_INTRA

from .frame import flat_windows


@dataclass(frozen=True)
class MCGeom:
    """Where plane c's extended (EH, S) region sits in each flat variant,
    and the block grid that tiles the (h, w) plane."""
    n: int       # flat length of one variant (stride between variants)
    start: int   # flat index of the extended plane's (0, 0)
    EH: int
    S: int
    E: int       # border
    w: int
    h: int
    BW: int
    BH: int
    nbh: int
    nbv: int


def predict_plain(vflat, g: MCGeom, inter, submask, ir, ic, phase):
    """Dense PyTorch form (the XLA compensate_plane, dsv1_tpu/ops/bmc.py
    :182-238). vflat: (4n,) u8 variants; inter/submask/ir/ic/phase:
    (nbv, nbh) int32 per-block fields — inter 1 for inter blocks, ir/ic
    the window origins in extended-plane coords. Returns (h, w) u8."""
    dev = vflat.device
    nbv, nbh, BH, BW, S, E = g.nbv, g.nbh, g.BH, g.BW, g.S, g.E
    ph, pw = g.h, g.w
    base = (phase.to(torch.int64) * g.n + g.start
            + ir.to(torch.int64) * S + ic)
    spans = flat_windows(vflat, base, BH, BW, S)        # (nbv, nbh, BH, BW)
    inter_val = spans.permute(0, 2, 1, 3).reshape(nbv * BH, nbh * BW) \
        [:ph, :pw].to(torch.int32)

    ref_plane = vflat[g.start:g.start + g.EH * S].reshape(g.EH, S) \
        [E:E + ph, E:E + pw]
    avg_full, avg_sub = _block_avgs(ref_plane, nbh, nbv, BW, BH)

    def up(blk2d):
        return blk2d.repeat_interleave(BH, 0).repeat_interleave(BW, 1) \
            [:ph, :pw]

    cw2 = (pw - torch.arange(nbh, device=dev) * BW).clamp(0, BW)
    ch2 = (ph - torch.arange(nbv, device=dev) * BH).clamp(0, BH)
    sbw_px = up((cw2 // 2)[None, :].expand(nbv, nbh))
    sbh_px = up((ch2 // 2)[:, None].expand(nbv, nbh))
    sub_px = up(submask.to(torch.int32))
    lx = (torch.arange(pw, device=dev) % BW)[None, :]
    ly = (torch.arange(ph, device=dev) % BH)[:, None]
    qx = (lx >= sbw_px).to(torch.int32)
    qy = (ly >= sbh_px).to(torch.int32)
    in_sub = (lx < 2 * sbw_px) & (ly < 2 * sbh_px) & (sbw_px > 0) \
        & (sbh_px > 0)
    mask_bit = (sub_px >> (qy * 2 + qx)) & 1
    quad_avg = torch.where(
        qy == 0,
        torch.where(qx == 0, up(avg_sub[:, :, 0, 0]), up(avg_sub[:, :, 0, 1])),
        torch.where(qx == 0, up(avg_sub[:, :, 1, 0]), up(avg_sub[:, :, 1, 1])))
    intra_val = torch.where(
        sub_px == MASK_ALL_INTRA, up(avg_full),
        torch.where(~in_sub, 0,
                    torch.where(mask_bit == 1, quad_avg,
                                ref_plane.to(torch.int32))))
    pred = torch.where(up(inter.to(torch.int32)) == 1, inter_val, intra_val)
    return pred.to(torch.uint8)


def _block_avgs(ref_plane, nbh: int, nbv: int, bw: int, bh: int):
    """Whole-block and quadrant DC averages over clipped block dims, by
    an integral image (bmc.c:176-189; the JAX twin's u32 box sums are
    exact, as are these int64 ones)."""
    dev = ref_plane.device
    ph, pw = ref_plane.shape
    ii = torch.zeros((ph + 1, pw + 1), dtype=torch.int64, device=dev)
    ii[1:, 1:] = ref_plane.to(torch.int64).cumsum(0).cumsum(1)
    bj = torch.arange(nbv, device=dev)[:, None].expand(nbv, nbh)
    bi = torch.arange(nbh, device=dev)[None, :].expand(nbv, nbh)
    x0, y0 = bi * bw, bj * bh
    cw = (pw - x0).clamp(0, bw)
    ch = (ph - y0).clamp(0, bh)

    def boxsum(ya, xa, yb, xb):
        ya, yb = ya.clamp(0, ph), yb.clamp(0, ph)
        xa, xb = xa.clamp(0, pw), xb.clamp(0, pw)
        return ii[yb, xb] - ii[ya, xb] - ii[yb, xa] + ii[ya, xa]

    area = (cw * ch).clamp(min=1)
    avg_full = (boxsum(y0, x0, y0 + ch, x0 + cw) // area).to(torch.int32)
    sbw, sbh = cw // 2, ch // 2
    sarea = (sbw * sbh).clamp(min=1)
    rows = []
    for qy in (0, 1):
        row = []
        for qx in (0, 1):
            sx0, sy0 = x0 + qx * sbw, y0 + qy * sbh
            row.append((boxsum(sy0, sx0, sy0 + sbh, sx0 + sbw) // sarea)
                       .to(torch.int32))
        rows.append(torch.stack(row, -1))
    return avg_full, torch.stack(rows, -2)   # [nbv, nbh], [nbv, nbh, qy, qx]


def predict(vflat, g: MCGeom, inter, submask, ir, ic, phase):
    """Prediction plane (h, w) u8: plain version on CPU tensors, the CUDA
    kernel on CUDA tensors."""
    if not vflat.is_cuda:
        return predict_plain(vflat, g, inter, submask, ir, ic, phase)
    return predict_cuda(vflat, g, inter, submask, ir, ic, phase)


def predict_cuda(vflat, g: MCGeom, inter, submask, ir, ic, phase):
    """Launch csrc/mc.cu dsv1_mc_predict: one thread block per motion
    block."""
    from ..kernels.build import LAUNCHES, check, lib, stream_ptr
    if vflat.dtype != torch.uint8 or not vflat.is_contiguous():
        raise ValueError("vflat must be a contiguous uint8 tensor")
    if vflat.numel() != 4 * g.n:
        raise ValueError("vflat must hold 4 variants of length n")
    dev = vflat.device
    f = [x.to(device=dev, dtype=torch.int32).contiguous().reshape(-1)
         for x in (inter, submask, ir, ic, phase)]
    for x in f:
        if x.numel() != g.nbh * g.nbv:
            raise ValueError("per-block field has the wrong size")
    out = torch.empty((g.h, g.w), dtype=torch.uint8, device=dev)
    err = lib().dsv1_mc_predict(
        vflat.data_ptr(), g.n, g.start, g.EH, g.S, g.E, g.w, g.h, g.BW,
        g.BH, g.nbh, g.nbv, f[0].data_ptr(), f[1].data_ptr(),
        f[2].data_ptr(), f[3].data_ptr(), f[4].data_ptr(), out.data_ptr(),
        stream_ptr(vflat))
    check(err, "dsv1_mc_predict")
    LAUNCHES["mc"] += 1
    return out
