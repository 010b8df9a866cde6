"""Hierarchical motion estimation, batched over frame pairs (mirror of the
`hme_batch` path of dsv1_tpu/ops/hme.py).

The reference searches a luma pyramid top-down (hme.c:378-728): per
block, candidate MVs inherited from 5 parent positions, SAD selection,
a 9-point full-pel refine and, at level 0, an 8-point half-pel refine
plus an HVS-driven intra/inter cascade. ops/hme_kernels.py does the
search: `refine_coarse` the coarse levels with their candidates (one C
call on the GPU), `refine_base_cm` level 0 on those candidates as they
come (effort 0), or `refine_level` and `refine_wide` (effort 1..3, the
beyond-reference wider level-0 search); the chroma-variance term and
the neighbour-coupled high-detail pass are tensor code here.
"""

import torch

from ..constants import (HP_SAD_SZ, MASK_ALL_INTRA, MODE_INTER,
                         MODE_INTRA, format_h_shift, format_v_shift)

from . import hme_kernels as hk
from .cint import U32
from .frame import FrameLayout, plane_view


def _block_sqrvar_dense(imgs, layout: FrameLayout, c: int, cbw: int,
                        cbh: int, nbh: int, nbv: int, ccw, cch):
    """y_sqrvar (hme.c:247-267) over every grid-aligned block of plane c,
    (B, nb) with the reference's u32 wrap; ccw/cch: clipped dims (nb,)."""
    plane = plane_view(imgs, layout, c).to(torch.int64)
    B, ph, pw = plane.shape
    hp, wp = nbv * cbh, nbh * cbw
    if (hp, wp) != (ph, pw):
        plane = torch.nn.functional.pad(plane, (0, wp - pw, 0, hp - ph))
    t = plane.reshape(B, nbv, cbh, nbh, cbw)
    s = t.sum(dim=(2, 4)).reshape(B, -1)
    ss = (t * t).sum(dim=(2, 4)).reshape(B, -1)
    area = (ccw * cch).clamp(min=1).to(torch.int64)
    return (ss - ((s * s) & U32) // area) & U32


def refine_base_from_kernel(src_imgs, ref_imgs, layout: FrameLayout,
                            blk_w: int, blk_h: int, nbh: int, nbv: int,
                            subsamp: int, kouts):
    """Finish level 0 from the base kernel's per-block outputs: the
    chroma-variance cascade term (hme.c:667-682) and the neighbour-
    coupled high_detail pass (hme.c:620-648). Batched over B pairs."""
    mvx, mvy, flags, qbits, luma_tex, src_var = kouts
    p = layout.planes[0]
    dev = mvx.device
    B = mvx.shape[0]
    gj, gi = torch.meshgrid(torch.arange(nbv, device=dev),
                            torch.arange(nbh, device=dev), indexing="ij")
    bx, by = gi.reshape(-1) * blk_w, gj.reshape(-1) * blk_h
    inframe = (bx < p.w) & (by < p.h)
    bw_c = (p.w - bx).clamp(0, blk_w)
    bh_c = (p.h - by).clamp(0, blk_h)

    hs, vs = format_h_shift(subsamp), format_v_shift(subsamp)
    cbw, cbh = blk_w >> hs, blk_h >> vs
    ccw, cch = bw_c >> hs, bh_c >> vs
    cvars = []
    for imgs in (src_imgs, ref_imgs):
        v = [_block_sqrvar_dense(imgs, layout, c, cbw, cbh, nbh, nbv,
                                 ccw, cch) for c in (1, 2)]
        cvars.append(torch.maximum(v[0], v[1]))
    cvarS, cvarR = cvars

    go_intra = ((flags & hk.FLAG_GO_INTRA) != 0) \
        | (cvarR > ((4 * cvarS) & U32))
    not_intra = (flags & hk.FLAG_NOT_INTRA) != 0
    lo_tex = ((flags & hk.FLAG_LO_TEX) != 0).to(torch.int32)
    lo_var = ((flags & hk.FLAG_LO_VAR) != 0).to(torch.int32)
    submask = MASK_ALL_INTRA & ~qbits
    is_intra = go_intra & ~not_intra & (submask != 0) & inframe
    mode = torch.where(is_intra, MODE_INTRA, MODE_INTER).to(torch.int32)
    submask = torch.where(is_intra, submask, 0).to(torch.int32)
    mvx = torch.where(inframe, mvx, 0)
    mvy = torch.where(inframe, mvy, 0)

    def grid(x):
        return x.reshape(B, nbv, nbh)

    g_mode, g_lotex, g_lovar = grid(mode), grid(lo_tex), grid(lo_var)
    strong = (g_mode == MODE_INTER) & (g_lotex == 0) & (g_lovar == 0)

    def shifted(a, dy_, dx_):
        out = torch.zeros_like(a)
        out[:, dy_:, dx_:] = a[:, :a.shape[1] - dy_, :a.shape[2] - dx_]
        return out

    left, top, topleft = (shifted(strong, 0, 1), shifted(strong, 1, 0),
                          shifted(strong, 1, 1))
    HP = HP_SAD_SZ
    thresh_var = torch.full((B, nbv, nbh), HP * HP, dtype=torch.int32,
                            device=dev)
    thresh_var = torch.where(left, thresh_var * HP, thresh_var)
    thresh_var = torch.where(top, thresh_var * HP, thresh_var)
    thresh_var = torch.where(topleft, thresh_var * (HP // 4), thresh_var)
    thresh_tex = 1 + left.to(torch.int32) + top.to(torch.int32) \
        + topleft.to(torch.int32)
    high_detail = ((grid(luma_tex) > thresh_tex)
                   & (grid(src_var) > thresh_var)
                   & grid(inframe.expand(B, -1)))
    return {
        "mode": g_mode,
        "mvx": grid(mvx),
        "mvy": grid(mvy),
        "submask": grid(submask),
        "lo_tex": g_lotex,
        "lo_var": g_lovar,
        "high_detail": high_detail.to(torch.int32),
        "nintra": is_intra.to(torch.int32).sum(dim=1),
    }


def hme_batch(src_flats, ref_flats, layouts, blk_w: int, blk_h: int,
              nbh: int, nbv: int, subsamp: int, levels: int,
              calls: list | None = None, effort: int = 0):
    """Batched dsv_hme over a leading frame-pair axis.

    src_flats/ref_flats: per pyramid level, (B, flat) u8 images (level 0
    the full frame). Returns the level-0 dict with a leading B axis.
    At effort 0 level 0 is `refine_base_cm` on the coarse search's
    candidates; at effort 1..3 (the JAX package's hme_batch,
    dsv1_tpu/ops/hme.py:769-792) the candidate search and 9-point
    refine of `refine_level` at level 0, then `refine_wide`'s +-2 effort
    full-pel window, half-pel grid and luma cascade.
    When `calls` is a list, each kernel call's (name, args) is appended
    to it, so a caller can rerun a kernel on exactly these arguments."""
    cargs = (src_flats, ref_flats, layouts, blk_w, blk_h, nbh, nbv, levels)
    if calls is not None:
        calls.append(("hme_coarse", cargs))
    cm = hk.refine_coarse(*cargs)
    nb = nbh * nbv
    if effort == 0:
        args = (src_flats[0], ref_flats[0], layouts[0], cm, nbh, nb, blk_w,
                blk_h)
        if calls is not None:
            calls.append(("hme_base", args))
        kouts = hk.refine_base_cm(*args)
    else:
        nc = cm.shape[-1] // 2
        args = (src_flats[0], ref_flats[0], layouts[0], cm[..., :nc],
                cm[..., nc:], nbh, nb, blk_w, blk_h, 0)
        if calls is not None:
            calls.append(("hme_level0", args))
        pre = hk.refine_level(*args)
        wargs = (src_flats[0], ref_flats[0], layouts[0], nbh, nb, blk_w,
                 blk_h, pre, effort)
        if calls is not None:
            calls.append(("hme_wide", wargs))
        kouts = hk.refine_wide(*wargs)
    out = refine_base_from_kernel(src_flats[0], ref_flats[0], layouts[0],
                                  blk_w, blk_h, nbh, nbv, subsamp, kouts)
    out["intra_pct"] = out["nintra"] * 100 // nb
    return out
