"""HME search kernels: CUDA kernels + plain PyTorch versions.

Replaces the Pallas kernels of dsv1_tpu/ops/pallas_hme.py:

- `refine_coarse`: `_refine_kernel` (pallas_hme.py:130) over every
  coarse pyramid level, `levels`..1, and the candidate construction
  between them. Per level and block: masked SAD against up to NC
  candidate MVs (shifted `>> level`) with border-validity bounds and a
  strict first-minimum pick, the full-pel clamp, then the 9-point XF/YF
  refine; each level's candidates are the zero MV and five parent-grid
  neighbours in the level above's field. Returns the level-0
  candidates, (B, nb, 2 NC). On the GPU one C call launches one kernel
  per level and one that writes the level-0 candidates, with no host
  work between; it counts each of those kernels as a launch.
- `refine_level`: one such level on given candidates.
- `refine_base_cm`: `_base_kernel` (pallas_hme.py:339) and its banded
  form (:662), on `refine_coarse`'s candidates as they come. Level 0 at
  effort 0: the same search, the 8-point half-pel refine on 14x14
  windows with the 4-tap filters applied in-kernel, block
  texture/variance with u32 wrap, the zero-MV intra test, the luma
  GO_INTRA cascade and the quadrant good/evil metric. `refine_base` is
  the same on the candidates' x and y halves.
- `refine_wide`: level 0 at effort 1..3 after `refine_level` at level
  0, replacing XLA code of the JAX package (its refine_base with `pre`,
  dsv1_tpu/ops/hme.py:324-420), not a Pallas kernel: an exhaustive
  +-2 effort full-pel window, a +-(1 + effort) half-pel grid in place
  of the 8 neighbours, then `refine_base`'s luma cascade.

Every function takes the flat images of its level, (B, n) u8, and the
level's FrameLayout, and reads every window from the flat image at its
own origin, as the JAX package's XLA search (`_refine_common`, the CPU
route, which wrote the goldens) reads it: a row past the right edge runs
on into the next row, rows below the luma plane are the chroma planes'
bytes, and offsets before the image or past its end clip to its first
or last chunk (`flat_windows_clipped`). The Pallas bodies clamp each
origin into the extended plane instead, so at the +-64 level-0 limit
the JAX package's TPU route differs from its CPU route; the port follows
the CPU route. The kernels (csrc/hme.cu) read pixels four to a 32-bit
word, so their wrappers require word-aligned images, strides, borders
and block widths, and check that no window can leave the image (it
cannot in any layout of `frame.make_layout`); they raise otherwise. The
wrappers take the plain version for CPU tensors and launch the kernels
for CUDA tensors; there is no fallback.
"""

import ctypes

import numpy as np
import torch

from ..constants import FRAME_BORDER

from .cint import U32
from .frame import FrameLayout

# search point tables (hme.c:422-427, 27-30)
XF = (0, 1, -1, 0, 0, -1, 1, -1, 1)
YF = (0, 0, 0, 1, -1, -1, -1, 1, 1)
XH = (1, -1, 0, 0, -1, 1, -1, 1)
YH = (0, 0, 1, -1, -1, -1, 1, 1)
HP = 14      # HP_SAD_SZ
NB_W = 24    # half-pel neighbourhood (>= HP + 2 origin + 3 taps)
IMAX = 2**31 - 1
# parent candidate offsets (hme.c:454)
PT = ((0, 0), (-2, 0), (2, 0), (0, -2), (0, 2))

# flag bits of refine_base's `flags` output (as in pallas_hme.py)
FLAG_GO_INTRA = 1   # luma intra-cascade verdict (chroma term added later)
FLAG_NOT_INTRA = 2  # block_intra_test: the block can't survive intra
FLAG_LO_TEX = 4
FLAG_LO_VAR = 8
FLAG_HP_HIT = 16


def _s32(x):
    """int64 -> the int32 value of its low 32 bits (two's complement)."""
    return ((x + 2**31) & U32) - 2**31


class _Grid:
    """Per-block geometry of one level (block t at grid (t % nbh_l,
    t // nbh_l)) and a window gatherer over the batch of flat images."""

    def __init__(self, src_flat, ref_flat, layout, nbh_l, nb, BW, BH):
        p = layout.planes[0]
        dev = src_flat.device
        self.B = src_flat.shape[0]
        self.S, self.org = p.stride, layout.margin + p.offset
        self.w, self.h, self.BW, self.BH = p.w, p.h, BW, BH
        w, h = p.w, p.h
        self.src, self.ref = src_flat, ref_flat
        t = torch.arange(nb, device=dev)
        self.bx = (t % nbh_l) * BW
        self.by = torch.div(t, nbh_l, rounding_mode="floor") * BH
        self.inframe = (self.bx < w) & (self.by < h)
        self.bw_c = (w - self.bx).clamp(0, BW)
        self.bh_c = (h - self.by).clamp(0, BH)
        cols = torch.arange(BW, device=dev)[None, None, :]
        rows = torch.arange(BH, device=dev)[None, :, None]
        self.mask = ((cols < self.bw_c[:, None, None])    # (nb, BH, BW)
                     & (rows < self.bh_c[:, None, None]))

    def win(self, flat, y, x, H, W):
        """(B, nb, H, W) int32 windows at frame coordinates (y, x), each
        (nb,) or (B, nb), read from the flat images as the JAX gather
        reads them."""
        base = self.org + y.to(torch.int64) * self.S + x
        return flat_windows_clipped(flat, base.expand(self.B, -1), H, W,
                                    self.S)

    def srcw(self):
        return self.win(self.src, self.by, self.bx, self.BH, self.BW)

    def sad(self, a, b):
        d = (a - b).abs()
        return torch.where(self.mask, d, 0).sum(dim=(-2, -1))


def _search(g: _Grid, cm, NC: int, level: int, srcw):
    """Candidate SADs + first-minimum pick + full-pel clamp + 9-point
    refine. Returns (dx, dy, best) in level units, each (B, nb)."""
    b = FRAME_BORDER
    BW, BH, w, h = g.BW, g.BH, g.w, g.h
    bsad = torch.full_like(g.bx.expand(g.B, -1), IMAX)
    bk = torch.zeros_like(bsad)
    for k in range(NC):
        rx = g.bx + (cm[..., k] >> level)
        ry = g.by + (cm[..., NC + k] >> level)
        ok = ((rx >= -b) & (ry >= -b) & (rx + g.bw_c <= w + b)
              & (ry + g.bh_c <= h + b) & g.inframe)
        refw = g.win(g.ref, ry, rx, BH, BW)
        sad = torch.where(ok, g.sad(srcw, refw), IMAX)
        take = sad < bsad
        bk = torch.where(take, k, bk)
        bsad = torch.where(take, sad, bsad)
    bdx = cm[..., :NC].gather(-1, bk[..., None])[..., 0] >> level
    bdy = cm[..., NC:].gather(-1, bk[..., None])[..., 0] >> level
    bdx = torch.minimum(torch.maximum(bdx, -g.bw_c - g.bx), w - g.bx)
    bdy = torch.minimum(torch.maximum(bdy, -g.bh_c - g.by), h - g.by)

    padw = g.win(g.ref, g.by + bdy - 1, g.bx + bdx - 1, BH + 2, BW + 2)
    best = torch.full_like(bsad, IMAX)
    m9 = torch.zeros_like(bsad)
    for k in range(9):
        oy, ox = YF[k] + 1, XF[k] + 1
        sad = g.sad(srcw, padw[..., oy:oy + BH, ox:ox + BW])
        take = sad < best
        m9 = torch.where(take, k, m9)
        best = torch.where(take, sad, best)
    xf = torch.tensor(XF, device=m9.device)
    yf = torch.tensor(YF, device=m9.device)
    return bdx + xf[m9], bdy + yf[m9], best


def _cands(cmx, cmy):
    """(B, nb, 2 NC) int32 candidates, x then y."""
    return torch.cat([cmx, cmy], dim=-1).to(torch.int32).contiguous()


def refine_level_plain(src_flat, ref_flat, layout, cmx, cmy, nbh_l, nb, BW,
                       BH, level):
    """Plain form of `_refine_kernel` with the XLA search's reads: (dx,
    dy, best), each (B, nb)."""
    g = _Grid(src_flat, ref_flat, layout, nbh_l, nb, BW, BH)
    cm = _cands(cmx, cmy)
    return _search(g, cm, cmx.shape[-1], level, g.srcw())


def _lvl_grid(level: int, nbh: int, nbv: int):
    step = 1 << level
    return step, np.arange(0, nbh, step), np.arange(0, nbv, step)


def _build_cands_batched(level: int, mvf, nbh: int, nbv: int):
    """mvf: (B, nbv, nbh, 2) -> (B, nb, 6) cmx, cmy (full-res units):
    slot 0 the zero MV, slots 1-5 the parent-grid neighbours, zeroed
    when out of grid or all-zero (hme.c:452-510)."""
    step, ii, jj = _lvl_grid(level, nbh, nbv)
    gj, gi = np.meshgrid(jj, ii, indexing="ij")
    gi, gj = gi.reshape(-1), gj.reshape(-1)
    B = mvf.shape[0]
    dev = mvf.device
    parent_mask = ~((step << 1) - 1)
    pi, pj = gi & parent_mask, gj & parent_mask
    zero = torch.zeros((B, gi.size), dtype=torch.int32, device=dev)
    cxs, cys = [zero], [zero]
    for (ox, oy) in PT:
        x = pi + ox * step
        y = pj + oy * step
        ok = torch.as_tensor((x >= 0) & (x < nbh) & (y >= 0) & (y < nbv),
                             device=dev)
        xc = torch.as_tensor(np.clip(x, 0, nbh - 1), device=dev)
        yc = torch.as_tensor(np.clip(y, 0, nbv - 1), device=dev)
        mv = mvf[:, yc, xc]                               # (B, nb, 2)
        keep = ok[None, :, None] & (mv != 0).any(-1, keepdim=True)
        mv = torch.where(keep, mv, 0)
        cxs.append(mv[..., 0])
        cys.append(mv[..., 1])
    return torch.stack(cxs, -1), torch.stack(cys, -1)


def refine_coarse_plain(src_levels, ref_levels, layouts, blk_w, blk_h, nbh,
                        nbv, levels):
    """Plain form of `refine_coarse`: the level loop of the JAX package's
    `hme_batch` (dsv1_tpu/ops/hme.py:731-767) through
    `refine_level_plain`, and the level-0 candidates."""
    mvf = None
    for level in range(levels, 0, -1):
        lay = layouts[level]
        step, ii, jj = _lvl_grid(level, nbh, nbv)
        nbh_l, nbv_l = len(ii), len(jj)
        nb = nbh_l * nbv_l
        B = src_levels[level].shape[0]
        dev = src_levels[level].device
        if mvf is None:
            cmx = torch.zeros((B, nb, 1), dtype=torch.int32, device=dev)
            cmy = cmx
        else:
            cmx, cmy = _build_cands_batched(level, mvf, nbh, nbv)
        p = lay.planes[0]
        dx, dy, _ = refine_level_plain(src_levels[level], ref_levels[level],
                                       lay, cmx, cmy, nbh_l, nb, blk_w,
                                       blk_h, level)
        # block origin in level coords is (grid index * blk) >> level
        infr = torch.as_tensor(
            ((((ii * blk_w) >> level)[None, :] < p.w)
             & (((jj * blk_h) >> level)[:, None] < p.h)).reshape(-1),
            device=dev)
        mvx = torch.where(infr[None, :], dx << level, 0)
        mvy = torch.where(infr[None, :], dy << level, 0)
        field = torch.stack([mvx, mvy], -1).reshape(B, nbv_l, nbh_l, 2)
        mvf = torch.zeros((B, nbv, nbh, 2), dtype=torch.int32, device=dev)
        mvf[:, ::step, ::step] = field.to(torch.int32)
    if mvf is None:
        B = src_levels[0].shape[0]
        cmx = torch.zeros((B, nbh * nbv, 1), dtype=torch.int32,
                          device=src_levels[0].device)
        cmy = cmx
    else:
        cmx, cmy = _build_cands_batched(0, mvf, nbh, nbv)
    return _cands(cmx, cmy)


def _texture14(a):
    """block_texture (hme.c:180-210) on (..., 14, 14) int32 windows:
    (tex, avg, var) with var the reference's u32 result as int32."""
    a = a.to(torch.int64)
    s = a.sum(dim=(-2, -1))
    ss = (a * a).sum(dim=(-2, -1))
    sh = (a[..., :, 1:] - a[..., :, :-1]).abs().sum(dim=(-2, -1))
    sv = (a[..., 1:, :] - a[..., :-1, :]).abs().sum(dim=(-2, -1))
    n = HP * HP
    tex = (sh + sv) // 2 // n
    avg = s // n
    var = _s32(ss - ((s * s) & U32) // n)
    return tex, avg, var


def refine_base_plain(src_flat, ref_flat, layout, cmx, cmy, nbh_l, nb, BW,
                      BH):
    """Plain form of `_base_kernel` with the XLA search's reads: (mvx,
    mvy, flags, qbits, luma_tex, src_var), each (B, nb) int32."""
    g = _Grid(src_flat, ref_flat, layout, nbh_l, nb, BW, BH)
    cm = _cands(cmx, cmy)
    srcw = g.srcw()
    dx, dy, best = _search(g, cm, cmx.shape[-1], 0, srcw)
    return _luma_tail(g, srcw, dx, dy, best, XH, YH, 0)


def _hp_grid(effort: int):
    """The half-pel points level 0 tries around the full-pel best at
    effort 1..3, in place of the 8 unit neighbours XH/YH: the grid of
    +-(1 + effort) half-pels, row-major over (y, x), without (0, 0)
    (the JAX package's refine_base, dsv1_tpu/ops/hme.py:389-399)."""
    rh = 1 + effort
    pts = [(x, y) for y in range(-rh, rh + 1) for x in range(-rh, rh + 1)
           if (x, y) != (0, 0)]
    return tuple(x for x, _ in pts), tuple(y for _, y in pts)


def _luma_tail(g: _Grid, srcw, dx, dy, best, xh_pts, yh_pts, pad: int):
    """Level 0 after the full-pel search (dx, dy, best): the half-pel
    refine over the points (xh_pts, yh_pts) on 14x14 windows, the
    chosen and source centre-window statistics, the block metrics, the
    zero-MV intra test, the luma GO_INTRA cascade and the quadrant
    metric. The half-pel neighbourhood starts 2 + pad pixels before the
    full-pel centre window (pad 1 covers the +-2-pixel grid of effort 3).
    Returns (mvx, mvy, flags, qbits, luma_tex, src_var), (B, nb) int32."""
    BW, BH = g.BW, g.BH
    i64 = torch.int64
    best = best.to(i64)

    # --- half-pel refine (hme.c:543-597)
    yarea = g.bw_c * g.bh_c
    yareasq = yarea * yarea
    cx = g.bx + (g.bw_c >> 1) - HP // 2
    cy = g.by + (g.bh_c >> 1) - HP // 2
    srcw14 = g.win(g.src, cy, cx, HP, HP)
    o = 2 + pad
    nb_ = g.win(g.ref, cy + dy - o, cx + dx - o, NB_W, NB_W)
    hu = 9 * (nb_[..., :, 1:-2] + nb_[..., :, 2:-1]) \
        - (nb_[..., :, :-3] + nb_[..., :, 3:])
    h8 = ((hu + 8) >> 4).clamp(0, 255)
    v8 = ((9 * (nb_[..., 1:-2, :] + nb_[..., 2:-1, :])
           - (nb_[..., :-3, :] + nb_[..., 3:, :]) + 8) >> 4).clamp(0, 255)
    d8 = ((9 * (hu[..., 1:-2, :] + hu[..., 2:-1, :])
           - (hu[..., :-3, :] + hu[..., 3:, :]) + 128) >> 8).clamp(0, 255)

    def hp_window(xh, yh):
        """The 14x14 window of the half-pel point (xh, yh): a filtered
        plane picked by its phase, at its pixel offset (xh >> 1, yh >> 1)
        from the full-pel centre window."""
        r, c = o + (yh >> 1), o + (xh >> 1)
        if xh & 1 and yh & 1:
            return d8[..., r - 1:r - 1 + HP, c - 1:c - 1 + HP]
        if xh & 1:
            return h8[..., r:r + HP, c - 1:c - 1 + HP]
        if yh & 1:
            return v8[..., r - 1:r - 1 + HP, c:c + HP]
        return nb_[..., r:r + HP, c:c + HP]

    do_hp = (best > BW * BH) & g.inframe
    run_best = torch.div(best * (HP * HP), yarea.clamp(min=1),
                         rounding_mode="trunc")
    run_m = torch.full_like(best, -1)
    wins = []
    for k, (xh, yh) in enumerate(zip(xh_pts, yh_pts)):
        wk = hp_window(xh, yh)
        wins.append(wk)
        s = (srcw14 - wk).abs().sum(dim=(-2, -1))
        take = s < run_best
        run_m = torch.where(take, k, run_m)
        run_best = torch.where(take, s, run_best)
    hp_hit = do_hp & (run_m >= 0)
    xh_t = torch.tensor(xh_pts, device=best.device)
    yh_t = torch.tensor(yh_pts, device=best.device)
    mk = run_m.clamp(min=0)
    mvx = torch.where(hp_hit, (dx << 1) + xh_t[mk], dx << 1)
    mvy = torch.where(hp_hit, (dy << 1) + yh_t[mk], dy << 1)
    best = torch.where(hp_hit, torch.div(run_best * yarea, HP * HP,
                                         rounding_mode="trunc"), best)

    # --- chosen and source centre-window statistics
    selw = nb_[..., o:o + HP, o:o + HP]
    for k in range(len(wins)):
        sel = (hp_hit & (run_m == k))[..., None, None]
        selw = torch.where(sel, wins[k], selw)
    rtex, ravg, rvar = _texture14(selw)
    stex, savg, svar = _texture14(srcw14)

    # --- block metrics with u32 wrap (hme.c:598-648)
    mm = g.mask
    sm = torch.where(mm, srcw, 0).to(i64)
    s_sum = sm.sum(dim=(-2, -1))
    s_ss = (sm * sm).sum(dim=(-2, -1))
    dh = (srcw[..., :, 1:] - srcw[..., :, :-1]).abs()
    dv = (srcw[..., 1:, :] - srcw[..., :-1, :]).abs()
    sh_ = torch.where(mm[..., :, 1:], dh, 0).sum(dim=(-2, -1))
    sv_ = torch.where(mm[..., 1:, :], dv, 0).sum(dim=(-2, -1))
    area = yarea.clamp(min=1).to(i64)
    luma_tex = torch.div(torch.div(sh_ + sv_, 2, rounding_mode="trunc"),
                         area, rounding_mode="trunc")
    luma_var = (s_ss - ((s_sum * s_sum) & U32) // area) & U32
    lo_tex = (luma_tex <= 2) & g.inframe
    lo_var = (yareasq.to(i64) > luma_var) & g.inframe

    # zero-MV window: zvar + block_intra_test (hme.c:143-178,653)
    zerow = g.win(g.ref, g.by, g.bx, BH, BW)
    zu = torch.where(mm, zerow, 0).to(i64)
    z_s = zu.sum(dim=(-2, -1))
    z_ss = (zu * zu).sum(dim=(-2, -1))
    zvar = (z_ss - ((z_s * z_s) & U32) // area) & U32
    ravg0 = (z_s // area)[..., None, None]
    inner = (srcw - ravg0 + 128).clamp(0, 255)
    dif0 = (ravg0 + inner - 128).clamp(0, 255)
    not_intra = ((dif0 != srcw) & mm).any(dim=-1).any(dim=-1)

    go_intra = (((stex < 2) & (zvar > ((luma_var * 2) & U32)))
                | (rvar > _s32(svar * 2))
                | ((stex == 0) & (rtex != 0))
                | ((savg - ravg).abs() > 8)
                | ((luma_tex <= 10) & (best > yareasq // 16)))

    # --- sub-block intra metric (hme.c:89-134,684-712)
    sbw = (g.bw_c // 2)[:, None, None]
    sbh = (g.bh_c // 2)[:, None, None]
    dif_f = (srcw - zerow).abs()
    ngood_f = torch.where(dif_f == 0, 192, torch.where(
        dif_f == 1, 128, torch.where(dif_f == 2, 96, 0)))
    nevil_f = torch.where(dif_f > 2, dif_f, 0)
    zdh = (zerow[..., :, 1:] - zerow[..., :, :-1]).abs()
    zdv = (zerow[..., 1:, :] - zerow[..., :-1, :]).abs()
    gh_f = torch.nn.functional.pad(dh + zdh, (1, 0))
    gv_f = torch.nn.functional.pad(dv + zdv, (0, 0, 1, 0))
    cols = torch.arange(BW, device=srcw.device)[None, None, :]
    rows = torch.arange(BH, device=srcw.device)[None, :, None]
    ethr = ((sbw + sbh) >> 1)[:, 0, 0]
    qb = torch.zeros_like(best)
    for qy in (0, 1):
        for qx in (0, 1):
            lcol = cols - qx * sbw
            lrow = rows - qy * sbh
            qm = (lcol >= 0) & (lcol < sbw) & (lrow >= 0) & (lrow < sbh)
            good = (torch.where(qm, ngood_f, 0).sum(dim=(-2, -1))
                    + torch.where(qm & (lcol >= 1), gh_f, 0)
                    .sum(dim=(-2, -1))
                    + torch.where(qm & (lrow >= 1), gv_f, 0)
                    .sum(dim=(-2, -1)))
            evil = torch.where(qm, nevil_f, 0).sum(dim=(-2, -1))
            clear = (stex > 1) & (good >= ethr * evil)
            qb = qb | torch.where(clear, 1 << (qy * 2 + qx), 0)

    flags = (torch.where(go_intra, FLAG_GO_INTRA, 0)
             | torch.where(not_intra, FLAG_NOT_INTRA, 0)
             | torch.where(lo_tex, FLAG_LO_TEX, 0)
             | torch.where(lo_var, FLAG_LO_VAR, 0)
             | torch.where(hp_hit, FLAG_HP_HIT, 0))
    i32 = torch.int32
    return (mvx.to(i32), mvy.to(i32), flags.to(i32), qb.to(i32),
            luma_tex.to(i32), svar.to(i32))


def chunk_width(S: int) -> int:
    """The JAX package's span_gather chunk (dsv1_tpu/ops/opt.py
    _chunk_width): the largest power-of-two divisor of the row stride,
    from 16 up to 128."""
    cw = 16
    while cw < 128 and S % (cw * 2) == 0:
        cw *= 2
    return cw


def flat_windows_clipped(flat, base, H: int, W: int, S: int):
    """(B, nb, H, W) int32 windows of the (B, n) u8 flat images, window
    (b, k) starting at flat offset base[b, k] (any sign) with rows S
    apart, read as the JAX package's span_gather reads them: byte f is
    byte f mod CW of the CW-byte chunk floor(f / CW) clipped to the
    image's chunks, so a row past the right edge runs on into the next
    row and offsets before the image or past its end land in its first
    or last chunk (CW = chunk_width(S))."""
    B, n = flat.shape
    cw = chunk_width(S)
    dev = flat.device
    off = (torch.arange(H, device=dev)[:, None] * S
           + torch.arange(W, device=dev)[None, :])
    f = base.to(torch.int64)[..., None, None] + off
    chunk = torch.div(f, cw, rounding_mode="floor").clamp(0, n // cw - 1)
    idx = (chunk * cw + torch.remainder(f, cw)
           + (torch.arange(B, device=dev) * n)[:, None, None, None])
    return flat.reshape(-1)[idx].to(torch.int32)


def refine_wide_plain(src_flat, ref_flat, layout, nbh_l, nb, BW, BH, pre,
                      effort):
    """Plain form of level 0 at effort > 0 (the JAX package's refine_base
    with `pre`, dsv1_tpu/ops/hme.py:324-420, and the luma part of its
    _base_tail): from the candidate search's (dx, dy, best) (`pre`,
    each (B, nb) int32), an exhaustive +-R full-pel window, R =
    2 effort, scanned raster over (oy, ox) without the centre, a move
    taken only on a strict improvement; then the half-pel grid of
    +-(1 + effort) and the luma cascade of `refine_base_plain`.
    src_flat/ref_flat: (B, n) u8 flat level-0 images. Returns (mvx, mvy,
    flags, qbits, luma_tex, src_var), each (B, nb) int32."""
    g = _Grid(src_flat, ref_flat, layout, nbh_l, nb, BW, BH)
    srcw = g.srcw()
    dx0, dy0, best = (t.to(torch.int64) for t in pre)
    R = 2 * effort
    padw = g.win(g.ref, g.by + dy0 - R, g.bx + dx0 - R, BH + 2 * R,
                 BW + 2 * R)
    dx, dy = dx0, dy0
    for oy in range(2 * R + 1):
        for ox in range(2 * R + 1):
            if oy == R and ox == R:
                continue   # the centre's SAD is `best`
            s = g.sad(srcw, padw[..., oy:oy + BH, ox:ox + BW])
            take = s < best
            best = torch.where(take, s, best)
            dx = torch.where(take, dx0 + (ox - R), dx)
            dy = torch.where(take, dy0 + (oy - R), dy)
    return _luma_tail(g, srcw, dx, dy, best, *_hp_grid(effort), 1)


def _planes(src_flat, ref_flat, layout: FrameLayout, BW: int, BH: int):
    """The kernels' view of a level's flat images: (src, ref) pointers to
    the (EH, S) luma planes of pair 0, the bytes between pairs, EH, S, E,
    w, h. Checks the layout the kernels read (uint8 images of the
    layout's size with contiguous rows, pixels loaded four to an aligned
    word) and that every window a search reads lies inside its image:
    the candidate windows inside the border-validity bounds, the 9-point
    windows (rows from -(BH + 1) before the frame), the half-pel
    neighbourhoods and the words around them."""
    p = layout.planes[0]
    n = layout.total + 2 * layout.margin
    for t in (src_flat, ref_flat):
        if t.dtype != torch.uint8 or t.dim() != 2 or t.stride(1) != 1 \
                or t.shape[1] != n:
            raise ValueError("images must be (B, n) uint8 flat images of the "
                             "layout, with contiguous rows")
        if t.data_ptr() % 4 or t.stride(0) % 4:
            raise ValueError("images must start on 4-byte words")
    if src_flat.shape != ref_flat.shape \
            or src_flat.stride(0) != ref_flat.stride(0):
        raise ValueError("src and ref images must have the same layout")
    S, E = p.stride, p.ext
    if S % 4 or E % 4 or BW % 4 or (layout.margin + p.offset) % 4:
        raise ValueError("row stride, border, frame origin and block width "
                         "must be multiples of 4")
    b = FRAME_BORDER
    org = layout.margin + p.offset
    lo = org - max(b, BH + 1) * S - max(b, BW + 1) - 4
    hi = org + (p.h + b + BH - 2) * S + p.w + b + BW + 8
    if lo < 0 or hi > n:
        raise ValueError("a search window could leave the image")
    start = org - E * S - E
    return (src_flat.data_ptr() + start, ref_flat.data_ptr() + start,
            src_flat.stride(0), p.h + 2 * E, S, E, p.w, p.h)


def _check_cands(src_flat, cmx, cmy):
    if cmx.shape != cmy.shape or cmx.shape[0] != src_flat.shape[0]:
        raise ValueError("candidate fields must be (B, nb, NC)")


def refine_level(src_flat, ref_flat, layout, cmx, cmy, nbh_l, nb, BW, BH,
                 level):
    """One pyramid level: (dx, dy, best) in level units, (B, nb).
    src_flat/ref_flat: (B, n) u8 flat images of the level's `layout`;
    cmx/cmy: (B, nb, NC) candidate MVs in full-res units."""
    if not src_flat.is_cuda:
        return refine_level_plain(src_flat, ref_flat, layout, cmx, cmy,
                                  nbh_l, nb, BW, BH, level)
    from ..kernels.build import LAUNCHES, launch
    planes = _planes(src_flat, ref_flat, layout, BW, BH)
    _check_cands(src_flat, cmx, cmy)
    B = src_flat.shape[0]
    cm = _cands(cmx, cmy)
    outs = [torch.empty((B, nb), dtype=torch.int32, device=src_flat.device)
            for _ in range(3)]
    launch("dsv1_hme_refine", src_flat, *planes[:2], cm.data_ptr(),
           *planes[2:], nbh_l, nb, BW, BH, cmx.shape[-1], level, B,
           *[o.data_ptr() for o in outs])
    LAUNCHES["hme_refine"] += 1
    if level == 0:
        LAUNCHES["hme_refine_level0"] += 1
    return tuple(outs)


def refine_coarse(src_levels, ref_levels, layouts, blk_w, blk_h, nbh, nbv,
                  levels):
    """Levels `levels`..1 of the search, each level's candidates built
    from the level above's field. src_levels/ref_levels: per level, the
    (B, n) u8 flat images (entries 1..levels are searched; entry 0 gives
    the batch and the device); layouts: the levels' FrameLayouts.
    Returns the level-0 candidates, (B, nbh * nbv, 2 NC) int32 (x then y,
    full-res units; NC = 6, or 1 (the zero MV) when levels is 0)."""
    if not src_levels[0].is_cuda:
        return refine_coarse_plain(src_levels, ref_levels, layouts, blk_w,
                                   blk_h, nbh, nbv, levels)
    B, dev = src_levels[0].shape[0], src_levels[0].device
    if levels == 0:
        return torch.zeros((B, nbh * nbv, 2), dtype=torch.int32, device=dev)
    from ..kernels.build import LAUNCHES, launch
    params, fields = [], 0
    for level in range(1, levels + 1):
        s, r = src_levels[level], ref_levels[level]
        if s.shape[0] != B:
            raise ValueError(f"level {level} images do not match the batch")
        params += list(_planes(s, r, layouts[level], blk_w, blk_h))
        step = 1 << level
        fields += 2 * B * -(-nbh // step) * -(-nbv // step)
    scratch = torch.empty(fields, dtype=torch.int32, device=dev)
    cm = torch.empty((B, nbh * nbv, 2 * (1 + len(PT))), dtype=torch.int32,
                     device=dev)
    launch("dsv1_hme_coarse", cm, (ctypes.c_int64 * len(params))(*params),
           levels, nbh, nbv, blk_w, blk_h, B, scratch.data_ptr(),
           cm.data_ptr())
    LAUNCHES["hme_refine"] += levels + 1   # a kernel per level, then cm
    return cm


def refine_base(src_flat, ref_flat, layout, cmx, cmy, nbh_l, nb, BW, BH):
    """Level 0 at effort 0 on candidates cmx/cmy (B, nb, NC): (mvx, mvy,
    flags, qbits, luma_tex, src_var), each (B, nb) int32."""
    _check_cands(src_flat, cmx, cmy)
    return refine_base_cm(src_flat, ref_flat, layout, _cands(cmx, cmy),
                          nbh_l, nb, BW, BH)


def refine_base_cm(src_flat, ref_flat, layout, cm, nbh_l, nb, BW, BH):
    """`refine_base` on candidates cm (B, nb, 2 NC) int32, x then y, as
    `refine_coarse` returns them."""
    nc = cm.shape[-1] // 2
    if not src_flat.is_cuda:
        return refine_base_plain(src_flat, ref_flat, layout, cm[..., :nc],
                                 cm[..., nc:], nbh_l, nb, BW, BH)
    from ..kernels.build import LAUNCHES, launch
    planes = _planes(src_flat, ref_flat, layout, BW, BH)
    B = src_flat.shape[0]
    if cm.dtype != torch.int32 or not cm.is_contiguous() \
            or cm.shape != (B, nb, 2 * nc):
        raise ValueError("candidates must be contiguous (B, nb, 2 NC) int32")
    outs = [torch.empty((B, nb), dtype=torch.int32, device=src_flat.device)
            for _ in range(6)]
    launch("dsv1_hme_base", src_flat, *planes[:2], cm.data_ptr(),
           *planes[2:], nbh_l, nb, BW, BH, nc, B,
           *[o.data_ptr() for o in outs])
    LAUNCHES["hme_base"] += 1
    return tuple(outs)


def refine_wide(src_flat, ref_flat, layout, nbh_l, nb, BW, BH, pre, effort):
    """Level 0 at effort 1..3 from the candidate search's `pre` = (dx,
    dy, best), each (B, nb) int32: (mvx, mvy, flags, qbits, luma_tex,
    src_var), each (B, nb) int32, as `refine_base_cm` gives them.
    src_flat/ref_flat: (B, n) u8 flat level-0 images of `layout`."""
    if effort not in (1, 2, 3):
        raise ValueError(f"effort must be 1, 2 or 3, not {effort}")
    if not src_flat.is_cuda:
        return refine_wide_plain(src_flat, ref_flat, layout, nbh_l, nb, BW,
                                 BH, pre, effort)
    from ..kernels.build import LAUNCHES, launch
    _, _, pstride, EH, S, E, w, h = _planes(src_flat, ref_flat, layout, BW,
                                            BH)
    B, n = src_flat.shape
    for t in pre:
        if t.dtype != torch.int32 or not t.is_contiguous() \
                or t.shape != (B, nb):
            raise ValueError("pre must be contiguous (B, nb) int32")
    outs = [torch.empty((B, nb), dtype=torch.int32, device=src_flat.device)
            for _ in range(6)]
    launch("dsv1_hme_wide", src_flat, src_flat.data_ptr(),
           ref_flat.data_ptr(), pstride, n,
           layout.margin + layout.planes[0].offset, EH, S, E, w, h,
           chunk_width(S).bit_length() - 1, nbh_l, nb, BW, BH, effort, B,
           *[t.data_ptr() for t in pre], *[o.data_ptr() for o in outs])
    LAUNCHES["hme_wide"] += 1
    return tuple(outs)
