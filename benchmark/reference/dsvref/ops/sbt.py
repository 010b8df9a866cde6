"""Subband (wavelet) transforms, integer-exact (mirror of dsv1_tpu/ops/sbt.py).

Per level a 2D Haar into LL/LH/HL/HH quadrants (reference sbt.c:267-349)
with truncating 4/5 LL scaling, plus the biorthogonal 4-tap transform
(B4T) on level 1 of intra frames (sbt.c:90-265). The luma inverse nudges
LH/HL toward the local LL gradient, bounded by +-hqp (sbt.c:437-574).

The forward transform carries the active LL region between levels;
each Haar level writes its LH/HL/HH bands straight into their
rectangles of the assembled coefficient array, and the last LL goes
into the top-left corner. `haar_fwd_pyramid` runs all the Haar levels of
a plane, or of a batch of planes, as a loop of `_haar_fwd_region`. The
intra level 1 (`b4t_fwd`, in `fwd_sbt`) and the whole inverse pyramid
(`inv_sbt`, and `inv_sbt_recon` with the recon epilogue: +128 clamped to
u8, the residual add of P planes, the plane written into the frame
image) are the JAX package's `_b4t_fwd_2d`, `inv_sbt`, `coefs_to_plane`
and `add_residual` in plain PyTorch. Every function takes any leading
batch dimensions; the last two are the plane's rows and columns. The inverse reads
each level's band pieces from the original array. Odd dimensions are
edge-replicated (forward) and zero-padded (inverse). `is_p` is a python bool here: the caller knows
each frame's type. B4T is defined for even dimensions only, as in the
JAX package.
"""

import torch
import torch.nn.functional as F

from ..constants import MAXLVL, MINQUANT, QP_I, QP_P, round_shift

from . import frame as fr
from .bmc import add_residual
from .cint import cdiv, lb2, round2, round4, round8, trunc_div


def nlevels(w: int, h: int) -> int:
    """C.3.3 num_levels (sbt.c:616-628)."""
    return lb2(max(w, h))


def get_quant(q, is_p: bool, level: int):
    """C.2.2 get_quant_lower_frequency (hzcc.c:77-92) of a python int q,
    or elementwise of an int32 tensor of quants."""
    if is_p:
        q = cdiv(q * 3, 2)
    if level == 1:
        q = cdiv(q * 2, 3)
    elif level == 2:
        q = cdiv(q * 3, 2)
    if isinstance(q, torch.Tensor):
        return q.clamp(min=MINQUANT)
    return max(q, MINQUANT)


def _scale_fwd(v):
    return trunc_div(v * 4, 5)


def _scale_inv(v):
    return trunc_div(v * 5, 4)


def _pad_even(r):
    """Edge-replicate to even dims (the C oddw/oddh branches)."""
    hs, ws = r.shape[-2:]
    if ws & 1:
        r = torch.cat([r, r[..., -1:]], dim=-1)
    if hs & 1:
        r = torch.cat([r, r[..., -1:, :]], dim=-2)
    return r


def _quad_dims(W: int, H: int, lvl: int):
    """Active region + quadrant dims at a level (sbt.c:630-651)."""
    ws = round_shift(W, lvl - 1)
    hs = round_shift(H, lvl - 1)
    return ws, hs, (ws + 1) // 2, (hs + 1) // 2, ws // 2, hs // 2


def _haar_fwd_region(r, scale_ll: bool):
    """C.3.1.2 Haar forward on the carried region: returns LL (ch,cw),
    LH (ch,fw), HL (fh,cw), HH (fh,fw)."""
    hs, ws = r.shape[-2:]
    fw, fh = ws // 2, hs // 2
    rp = _pad_even(r)
    x0 = rp[..., 0::2, 0::2]
    x1 = rp[..., 0::2, 1::2]
    x2 = rp[..., 1::2, 0::2]
    x3 = rp[..., 1::2, 1::2]
    LL = x0 + x1 + x2 + x3
    LH = x0 - x1 + x2 - x3
    HL = x0 + x1 - x2 - x3
    HH = x0 - x1 - x2 + x3
    if scale_ll:
        LL = _scale_fwd(LL)
    return LL, LH[..., :fw], HL[..., :fh, :], HH[..., :fh, :fw]


def _interleave2x2(a00, a01, a10, a11):
    lead, (ch, cw) = a00.shape[:-2], a00.shape[-2:]
    ev = torch.stack([a00, a01], dim=-1).reshape(lead + (ch, 2 * cw))
    od = torch.stack([a10, a11], dim=-1).reshape(lead + (ch, 2 * cw))
    return torch.stack([ev, od], dim=-2).reshape(lead + (2 * ch, 2 * cw))


def _check_even(n: int):
    if n % 2:
        raise ValueError("B4T (intra level 1) requires even dimensions")


def _b4t_fwd_rows(a):
    """C.3.2.1 forward B4T down the rows of a (even count)."""
    _check_even(a.shape[-2])
    even, odd = a[..., 0::2, :], a[..., 1::2, :]
    x0 = torch.cat([odd[..., :1, :], odd[..., :-1, :]], dim=-2)
    x3 = torch.cat([even[..., 1:, :], odd[..., -1:, :]], dim=-2)
    L = round2(3 * (even + odd) - x0 - x3)
    H = round2(x0 - 3 * even + 3 * odd - x3)
    return torch.cat([L, H], dim=-2)


def _b4t_inv_rows(a):
    """C.3.2.2 inverse B4T down the rows of a (even count)."""
    n = a.shape[-2]
    _check_even(n)
    m = n // 2
    L, H = a[..., :m, :], a[..., m:, :]
    Lp = torch.cat([L[..., :1, :], L[..., :-1, :]], dim=-2)
    Hp = torch.cat([H[..., :1, :], H[..., :-1, :]], dim=-2)
    Ln = torch.cat([L[..., 1:, :], L[..., -1:, :]], dim=-2)
    Hn = torch.cat([H[..., 1:, :], H[..., -1:, :]], dim=-2)
    evens = round8(Lp + 3 * L + Hp - 3 * H)
    odds = round8(3 * L + Ln + 3 * H - Hn)
    return torch.stack([evens, odds], dim=-2).reshape(a.shape)


def _b4t_fwd_2d(a):
    """fwd_b4t_2d (sbt.c:240-251): rows then columns."""
    return _b4t_fwd_rows(_b4t_fwd_rows(a.mT).mT)


def _b4t_inv_2d(a):
    """inv_b4t_2d (sbt.c:253-265): columns then rows."""
    return _b4t_inv_rows(_b4t_inv_rows(a).mT).mT


def _haar_fwd_pyramid_plain(cur, out, first: int, lvls: int):
    """The plain version of haar_fwd_pyramid: one `_haar_fwd_region` per
    level."""
    for i in range(first, lvls + 1):
        hs, ws = cur.shape[-2:]
        ch, cw, fh, fw = (hs + 1) // 2, (ws + 1) // 2, hs // 2, ws // 2
        cur, LH, HL, HH = _haar_fwd_region(cur, scale_ll=i > 1)
        out[..., :ch, cw:cw + fw] = LH
        out[..., ch:ch + fh, :cw] = HL
        out[..., ch:ch + fh, cw:cw + fw] = HH
    out[..., :cur.shape[-2], :cur.shape[-1]] = cur


def haar_fwd_pyramid(cur, out, first: int, lvls: int):
    """Forward Haar levels first..lvls of the region cur (hs, ws) int32
    (level `first` reads cur; LL scaled above level 1): every level's
    LH/HL/HH into its rectangles of the assembled coefficient array
    `out`, the last LL into its top-left corner; with no level to run,
    cur itself. cur must not overlap out. A batch of planes is cur
    (C, hs, ws) and out (C, H, W)."""
    hs, ws = cur.shape[-2:]
    if first > lvls:
        out[..., :hs, :ws] = cur
        return
    _haar_fwd_pyramid_plain(cur, out, first, lvls)
    return


def b4t_fwd_plain(a):
    """The plain version of b4t_fwd."""
    out = _b4t_fwd_2d(a)
    H, W = a.shape[-2:]
    return out, out[..., :H // 2, :W // 2].clone()


def b4t_fwd(a):
    """The intra level 1 of int32 planes a (..., H, W), H and W even: the
    B4T's four bands in place (H, W), and a contiguous copy of its LL
    quadrant (H / 2, W / 2), which the Haar levels read; a plane or a
    batch (C, H, W)."""
    H, W = a.shape[-2:]
    _check_even(H)
    _check_even(W)
    return b4t_fwd_plain(a)


def fwd_sbt(coefs, is_p: bool):
    """dsv_fwd_sbt (sbt.c:630-651) on centered int32 coefs (..., H, W)."""
    H, W = coefs.shape[-2:]
    lvls = nlevels(W, H)
    cur = coefs.to(torch.int32)
    first = 1
    if not is_p and lvls >= 1:
        # B4T level 1 gives all four bands in place; the Haar levels read
        # a copy of its LL, since they overwrite that corner
        out, cur = b4t_fwd(cur)
        first = 2
    else:
        out = torch.empty_like(cur)
    haar_fwd_pyramid(cur, out, first, lvls)
    return out


def _hqp_for_level(q, is_p: bool, i: int):
    """C.3.1.4 get_HQP (sbt.c:667-696) of a python int q, or elementwise
    of an int32 tensor of quants."""
    llq = cdiv(get_quant(q, is_p, 0), 2)
    if i > 3:
        return llq
    hqp = get_quant(q, is_p, MAXLVL - i)
    if i == 1:
        hqp = lb2(hqp) - (QP_P if is_p else QP_I)
        if isinstance(hqp, torch.Tensor):
            hqp = (torch.ones_like(hqp) << hqp.clamp(1, 24)) >> 1
        else:
            hqp = (1 << min(max(hqp, 1), 24)) >> 1
    return cdiv(hqp, 2)


def _nudge(LLv, lo, hi, band, mask, hqp: int):
    mx = LLv - hi
    mn = lo - LLv
    mn2 = torch.minimum(mn, mx)
    mx2 = torch.maximum(mn, mx)
    mx3 = mx2.clamp(max=0)
    mn3 = mn2.clamp(min=0)
    t = round4(lo - hi)
    nd = round2(torch.minimum(torch.maximum(t, mx3), mn3) - band * 2)
    nd = nd.clamp(-hqp, hqp)
    return torch.where(mask & (mx3 != mn3), band + nd, band)


def _haar_inv_region(cur, lh_col, hl_row, LH, HL, HH, ws: int, hs: int,
                     scale: bool, filtered: bool, hqp):
    """C.3.1.3/C.3.1.4 Haar inverse, one level (sbt.c:351-574), on the
    carried LL region (see the JAX twin for the neighbour reads)."""
    ch, cw = cur.shape[-2:]
    fw, fh = ws // 2, hs // 2
    inv_scale = _scale_inv if scale else (lambda v: v)
    LL = inv_scale(cur)
    if filtered:
        dev = cur.device
        lp = inv_scale(torch.cat([cur[..., :1], cur[..., :cw - 1]], dim=-1))
        ln = inv_scale(torch.cat([cur[..., 1:], lh_col], dim=-1))
        col = torch.arange(cw, device=dev)
        row = torch.arange(ch, device=dev)
        in_x = ((col >= 1) & (col <= fw - 1))[None, :] \
            & (row <= fh - 1)[:, None]
        LH = _nudge(LL, lp, ln, LH, in_x, hqp)
        up = inv_scale(torch.cat([cur[..., :1, :], cur[..., :ch - 1, :]],
                                 dim=-2))
        dn = inv_scale(torch.cat([cur[..., 1:, :], hl_row], dim=-2))
        in_y = ((row >= 1) & (row <= fh - 1))[:, None] \
            & (col <= fw - 1)[None, :]
        HL = _nudge(LL, up, dn, HL, in_y, hqp)
    a00 = trunc_div(LL + LH + HL + HH, 4)
    a01 = trunc_div(LL - LH + HL - HH, 4)
    a10 = trunc_div(LL + LH - HL - HH, 4)
    a11 = trunc_div(LL - LH - HL + HH, 4)
    return _interleave2x2(a00, a01, a10, a11)[..., :hs, :ws]


def inv_sbt_plain(coefs, q, is_p: bool, is_luma: bool):
    """The plain version of inv_sbt: `inv_levels` from the top level."""
    H, W = coefs.shape[-2:]
    lvls = nlevels(W, H)
    a = coefs.to(torch.int32)
    _, _, cwl, chl, _, _ = _quad_dims(W, H, lvls)
    return inv_levels(a, a[..., :chl, :cwl], W, H, q, is_p, is_luma, lvls,
                      1).contiguous()


def inv_levels(a, cur, W: int, H: int, q, is_p: bool, is_luma: bool,
               hi: int, lo: int):
    """Levels hi..lo of dsv_inv_sbt for a (W, H) plane: cur the LL region
    entering level hi, a the coefficient array (..., rows, cols) from its
    top-left corner, as far as these levels read it. Returns the LL
    region after level lo (the plane when lo is 1). q as in inv_sbt."""
    if isinstance(q, torch.Tensor):
        q = q.to(torch.int32).reshape(q.shape + (1, 1))
    for i in range(hi, lo - 1, -1):
        ws, hs, cw, ch, fw, fh = _quad_dims(W, H, i)
        hqp = _hqp_for_level(q, is_p, i) if is_luma else 0
        LHr = a[..., 0:ch, cw:cw + fw]
        LH = F.pad(LHr, (0, cw - fw))
        HL = F.pad(a[..., ch:ch + fh, 0:cw], (0, 0, 0, ch - fh))
        HH = F.pad(a[..., ch:ch + fh, cw:cw + fw], (0, cw - fw, 0, ch - fh))
        lh_col = a[..., 0:ch, cw:cw + 1]
        hl_row = a[..., ch:ch + 1, 0:cw]
        if i > 1 or is_p:
            cur = _haar_inv_region(cur, lh_col, hl_row, LH, HL, HH, ws, hs,
                                   scale=i > 1, filtered=is_luma, hqp=hqp)
        else:
            # B4T reads the raw bands: the level-1 in-place state is the
            # reconstructed LL corner + the original band rows
            full = torch.cat([torch.cat([cur, LHr], dim=-1),
                              a[..., ch:hs, 0:ws]], dim=-2)
            cur = _b4t_inv_2d(full)
    return cur


def coefs_to_plane(coefs):
    """sbc2int (C.3.3, sbt.c:594-614): +128 and clamp to u8."""
    return (coefs + 128).clamp(0, 255).to(torch.uint8)


def inv_sbt(coefs, q, is_p: bool, is_luma: bool):
    """dsv_inv_sbt (sbt.c:653-714) on int32 coefs (..., H, W). q: the
    quant, a python int, or an int32 tensor of the leading shape (a quant
    per plane of a batch); a plane or a batch (C, H, W)."""
    return inv_sbt_plain(coefs, q, is_p, is_luma)


def recon_epilogue_plain(v, img, layout, c: int, pred=None):
    """The recon epilogue of an inverse's int32 plane v (..., H, W): +128
    clamped to u8 (sbc2int), cut to plane c's (h, w), for a P plane the
    residual add of its prediction pred (..., h, w) u8 (addf: the second
    clamp), written with its replicated border and zero stride tail into
    plane c's rows of the frame images img (..., n) u8."""
    p = layout.planes[c]
    rp = coefs_to_plane(v)[..., :p.h, :p.w]
    if pred is not None:
        rp = add_residual(pred, rp)
    start = layout.margin + p.offset - p.stride * p.ext - p.ext
    img[..., start:start + p.stride * (p.h + 2 * p.ext)] = \
        fr._ext_plane_rows(rp, p)


def inv_sbt_recon(coefs, q, is_p: bool, is_luma: bool, img, layout,
                  c: int, pred=None):
    """The recon of plane c of a frame or of a batch of frames: inv_sbt of
    the written-back coefficients (..., H, W), then the recon epilogue
    (`recon_epilogue_plain`) into the frame images img (..., n) u8, whose
    margins and stride tails the caller has zeroed; pred: the plane's MC
    prediction (..., h, w) u8 for P frames; a plane or a batch (C, H,
    W)."""
    recon_epilogue_plain(inv_sbt_plain(coefs, q, is_p, is_luma), img,
                         layout, c, pred)
    return

