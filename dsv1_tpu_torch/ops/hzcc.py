"""HZCC quantization with in-loop write-back (mirror of dsv1_tpu/ops/hzcc.py).

Each plane is coded as one run-length stream over a fixed traversal:
the LL region (a ceil(w/8) x ceil(h/8) raster holding all coarse levels)
then the three finest levels' LH/HL/HH bands (reference hzcc.c:29-48).
Quantization is adaptive per block (hzcc.c:59-135) and the encoder
overwrites each coefficient with its dequantized value as it codes it
(hzcc.c:174,227,262). The traversal is a concatenation of rectangular
rasters, so each band is a slice of the coefficient grid, processed in
traversal order: when odd ceil dims make bands alias, later bands read
the values earlier bands wrote back, as in the reference.

`encode_plane_core` and `dequant_plane_grid` launch the kernels of
csrc/hzcc.cu (one launch for a batch of planes, one thread per grid
position walking the segments in traversal order; they replace the XLA
code of the JAX package's twins, dsv1_tpu/ops/hzcc.py:191, :236) on
CUDA tensors, and run their plain versions (`*_plain`, band by band)
on CPU tensors.

`compact_dense_i` and `compact_sparse_p` shrink a frame's quantized
planes on the device before the host reads them (intra planes as dense
int8 plus the LL's large values, P planes as capped (run, value) lists),
with the JAX package's layouts and overflow verdicts; `sparse_cap_div`
sizes the P cap from the quant. `encode_plane_core` and the compactions
take any leading batch dimensions (the planes of one frame index of
every GOP of a chunk), each element on its own. Where a cap overflows,
`compact_exact` (csrc/hzcc.cu on CUDA tensors) lists every symbol of a
chunk's planes, uncapped, at offsets from the counts the host already
read, and `exact_lists` cuts the host copy into each plane's (run,
value) lists.
"""

import ctypes
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..constants import (BLOCK_P, CHROMA_LIMIT, MAXLVL, MINQUANT,
                         NSUBBAND, QP_I, QP_P, round_shift)

from .cint import lb2, trunc_div
from .sbt import get_quant


@dataclass(frozen=True, eq=False)
class TraversalTables:
    """Static per-(W, H, nbh, nbv) traversal metadata."""
    perm: np.ndarray        # int32[N] flat coefficient index per position
    n: int
    nbh: int
    nbv: int
    # per segment: (lvl, oy, ox, sh, sw, block row per band row,
    #               block column per band column); lvl -1 is the LL region
    segs: tuple = ()


@lru_cache(maxsize=64)
def build_tables(W: int, H: int, nbh: int, nbv: int) -> TraversalTables:
    """C.1 subband order and traversal (hzcc.c:29-48)."""
    segs = []
    sw, sh = round_shift(W, MAXLVL), round_shift(H, MAXLVL)
    segs.append((-1, 0, 0, sh, sw))
    for lvl in range(MAXLVL):
        sw, sh = round_shift(W, MAXLVL - lvl), round_shift(H, MAXLVL - lvl)
        for s in range(1, NSUBBAND):
            ox = sw if (s & 1) else 0
            oy = sh if (s & 2) else 0
            segs.append((lvl, oy, ox, sh, sw))
    perms, segs_out = [], []
    for (lvl, oy, ox, sh, sw) in segs:
        ys, xs = np.mgrid[0:sh, 0:sw]
        perms.append(((oy + ys) * W + (ox + xs)).ravel().astype(np.int32))
        bj = bi = None
        if lvl >= 0:
            # 14-bit fixed-point block coordinate map (hzcc.c:59-74)
            bi = ((np.arange(sw) * ((nbh << BLOCK_P) // sw)) >> BLOCK_P)
            bj = ((np.arange(sh) * ((nbv << BLOCK_P) // sh)) >> BLOCK_P)
        segs_out.append((lvl, oy, ox, sh, sw, bj, bi))
    perm = np.concatenate(perms)
    return TraversalTables(perm=perm, n=int(perm.size), nbh=nbh, nbv=nbv,
                           segs=tuple(segs_out))


def frame_quants(q, is_p: bool, plane_idx: int):
    """(qp_ll, qp0, qp1, qp2_shift, qp2h_shift) for one plane
    (hzcc.c:50-57,199-208), of a python int q or elementwise of an int32
    tensor of quants."""
    t = isinstance(q, torch.Tensor)
    if plane_idx > 0:
        q = q.clamp(max=CHROMA_LIMIT) if t else min(q, CHROMA_LIMIT)
    qp_ll = get_quant(q, is_p, 0)
    qp1 = get_quant(q, is_p, 1)
    qp2 = lb2(get_quant(q, is_p, 2))
    qp2h = qp2 - (QP_P if is_p else QP_I)
    qp2h = qp2h.clamp(1, 24) if t else min(max(qp2h, 1), 24)
    return qp_ll, qp_ll, qp1, qp2, qp2h


def tmq4pos(qp: int, stable):
    """C.2.4 TMQ_for_position (hzcc.c:63-74) + MINQUANT floor."""
    t = torch.where((stable & 2) != 0, qp >> 2,
                    torch.where(stable != 0, qp >> 1, qp))
    return t.clamp(min=MINQUANT)


def quant_lo(v, q):
    """C.2 lower-frequency quantizer (hzcc.c:94-112)."""
    a = v.abs() << 1
    mag = trunc_div(a + 1, q << 1)
    res = torch.where(a <= q, 0, torch.where(v < 0, -mag, mag))
    return torch.where(v == 0, 0, res)


def dequant_lo(v, q):
    """C.2.1 dequantize_lower_frequency (hzcc.c:120-127)."""
    m = (v.abs() * (q << 1) + q) >> 1
    return torch.where(v < 0, -m, m)


def quant_hi(v, s):
    """C.2 highest-frequency shift quantizer (hzcc.c:114-118)."""
    a = v.abs() >> s
    return torch.where(v < 0, -a, a)


def dequant_hi(v, s):
    """C.2.1 dequantize_highest_frequency (hzcc.c:130-135)."""
    return v << s


def _band_stable(stable2d, bj, bi):
    """(..., sh, sw) stability flags of a band's positions."""
    dev = stable2d.device
    return stable2d.index_select(-2, torch.as_tensor(bj, device=dev)) \
        .index_select(-1, torch.as_tensor(bi, device=dev))


def _qparam(qp0, qp1, lvl: int, st):
    return tmq4pos(qp0 if lvl == 0 else qp1, st)


def encode_plane_core_plain(coefs, q, is_p: bool, plane_idx: int,
                            stable_blocks, tables: TraversalTables):
    """The plain version of encode_plane_core, band by band."""
    work = coefs.to(torch.int32).clone()
    lead = work.shape[:-2]
    if isinstance(q, torch.Tensor):
        q = q.to(torch.int32).reshape(lead + (1, 1))
    dc = work[..., 0, 0].clone()
    work[..., 0, 0] = 0  # hzcc.c:171 src[0] = 0
    qp_ll, qp0, qp1, qp2, qp2h = frame_quants(q, is_p, plane_idx)
    stable2d = stable_blocks.to(torch.int32).reshape(
        lead + (tables.nbv, tables.nbh))
    qparts = []
    for (lvl, oy, ox, sh, sw, bj, bi) in tables.segs:
        vals = work[..., oy:oy + sh, ox:ox + sw]
        if lvl == -1:
            qv = quant_lo(vals, qp_ll)
            wb = dequant_lo(qv, qp_ll)
        else:
            st = _band_stable(stable2d, bj, bi)
            if lvl < MAXLVL - 1:
                tmq = _qparam(qp0, qp1, lvl, st)
                qv = quant_lo(vals, tmq)
                wb = dequant_lo(qv, tmq)
            else:
                s = torch.where(st != 0, qp2h, qp2)
                qv = quant_hi(vals, s)
                wb = dequant_hi(qv, s)
        work[..., oy:oy + sh, ox:ox + sw] = torch.where(qv == 0, 0, wb)
        qparts.append(qv.reshape(lead + (-1,)))
    work[..., 0, 0] = dc  # dsv_encode_plane restores the raw DC
    return torch.cat(qparts, dim=-1), work


def dequant_plane_grid_plain(qgrid, dc, q, is_p: bool, plane_idx: int,
                             stable_blocks, tables: TraversalTables):
    """The plain version of dequant_plane_grid, band by band."""
    qgrid = qgrid.to(torch.int32)
    lead = qgrid.shape[:-2]
    if isinstance(q, torch.Tensor):
        q = q.to(torch.int32).reshape(lead + (1, 1))
    qp_ll, qp0, qp1, qp2, qp2h = frame_quants(q, is_p, plane_idx)
    stable2d = stable_blocks.to(torch.int32).reshape(
        lead + (tables.nbv, tables.nbh))
    out = torch.zeros_like(qgrid)
    for (lvl, oy, ox, sh, sw, bj, bi) in tables.segs:
        vals = qgrid[..., oy:oy + sh, ox:ox + sw]
        if lvl == -1:
            dq = dequant_lo(vals, qp_ll)
        else:
            st = _band_stable(stable2d, bj, bi)
            if lvl < MAXLVL - 1:
                dq = dequant_lo(vals, _qparam(qp0, qp1, lvl, st))
            else:
                dq = dequant_hi(vals, torch.where(st != 0, qp2h, qp2))
        out[..., oy:oy + sh, ox:ox + sw] = torch.where(vals == 0, 0, dq)
    out[..., 0, 0] = dc
    return out


@lru_cache(maxsize=64)
def _seg_array(tables: TraversalTables):
    """The kernels' segment table: (lvl, oy, ox, sh, sw) per segment."""
    vals = [v for (lvl, oy, ox, sh, sw, _bj, _bi) in tables.segs
            for v in (lvl, oy, ox, sh, sw)]
    return (ctypes.c_int * len(vals))(*vals)


def _hzcc_args(q, stable_blocks, C: int, dev, tables: TraversalTables):
    """The quant and stable-block arguments of csrc/hzcc.cu."""
    from ..kernels.build import per_plane
    if isinstance(q, torch.Tensor) and q.dtype != torch.int32:
        raise ValueError("q must be a python int or an int32 tensor")
    qp, qs, qv = per_plane(q, C, dev, "q")
    sp, ss, _ = per_plane(stable_blocks, C, dev, "stable_blocks",
                          tables.nbh * tables.nbv)
    seg = _seg_array(tables)
    return (seg, len(tables.segs), tables.nbh, tables.nbv, qp, qs, qv, sp,
            ss, int(stable_blocks.dtype == torch.uint8))


def encode_plane_core(coefs, q, is_p: bool, plane_idx: int, stable_blocks,
                      tables: TraversalTables):
    """Quantize + in-loop write-back (hzcc_enc, hzcc.c:138-293).

    coefs: (..., H, W) int32 from fwd_sbt, stable_blocks (..., nblk); q a
    python int, or an int32 tensor of the leading shape (a quant per
    plane of a batch). Returns (qvals (..., N) quantized values in
    traversal order, recon coefs with the dequantized write-back and the
    raw DC restored). CUDA tensors, a plane (H, W) or a batch (C, H, W):
    one launch of csrc/hzcc.cu; CPU tensors: the plain version."""
    if not coefs.is_cuda:
        return encode_plane_core_plain(coefs, q, is_p, plane_idx,
                                       stable_blocks, tables)
    from ..kernels.build import LAUNCHES, launch, packed_planes
    C, cb = packed_planes(coefs, "coefs")
    H, W = coefs.shape[-2:]
    args = _hzcc_args(q, stable_blocks, C, coefs.device, tables)
    lead = coefs.shape[:-2]
    qvals = torch.empty(lead + (tables.n,), dtype=torch.int32,
                        device=coefs.device)
    work = torch.empty(lead + (H, W), dtype=torch.int32, device=coefs.device)
    launch("dsv1_hzcc_quant", coefs, coefs.data_ptr(), cb, H, W, C, *args,
           int(bool(is_p)), plane_idx, qvals.data_ptr(), tables.n,
           work.data_ptr(), H * W)
    LAUNCHES["hzcc_quant"] += 1
    return qvals, work


def dequant_plane_grid(qgrid, dc, q, is_p: bool, plane_idx: int,
                       stable_blocks, tables: TraversalTables):
    """Dequantize a grid of quantized values (decode side of hzcc_dec,
    hzcc.c:296-435); qgrid is (..., H, W) in grid order, band aliases
    already resolved last-wins by the parser, stable_blocks (..., nblk).
    dc: the raw DC; dc and q python ints, or int32 tensors of the leading
    shape (a DC and a quant per plane of a batch). CUDA tensors, a plane
    (H, W) or a batch (C, H, W): one launch of csrc/hzcc.cu; CPU
    tensors: the plain version."""
    if not qgrid.is_cuda:
        return dequant_plane_grid_plain(qgrid, dc, q, is_p, plane_idx,
                                        stable_blocks, tables)
    from ..kernels.build import LAUNCHES, launch, packed_planes, per_plane
    C, gb = packed_planes(qgrid, "qgrid")
    H, W = qgrid.shape[-2:]
    args = _hzcc_args(q, stable_blocks, C, qgrid.device, tables)
    if isinstance(dc, torch.Tensor) and dc.dtype != torch.int32:
        raise ValueError("dc must be a python int or an int32 tensor")
    dp, ds, dv = per_plane(dc, C, qgrid.device, "dc")
    out = torch.empty(qgrid.shape[:-2] + (H, W), dtype=torch.int32,
                      device=qgrid.device)
    launch("dsv1_hzcc_dequant", qgrid, qgrid.data_ptr(), gb, H, W, C, *args,
           int(bool(is_p)), plane_idx, dp, ds, dv, out.data_ptr(), H * W)
    LAUNCHES["hzcc_dequant"] += 1
    return out


def ll_size(tables: TraversalTables) -> int:
    """Number of positions in the LL segment, the head of the traversal."""
    _lvl, _oy, _ox, sh, sw, _bj, _bi = tables.segs[0]
    return sh * sw


def _first_positions(flags, K: int, fill: int):
    """Indices of the first K true entries of the bool tensor flags
    (..., n), in order, `fill` past the last one, and the count of true
    entries (...): the k-th true entry is the first index where the
    running count reaches k (cumsum + searchsorted: fixed shapes, no host
    sync)."""
    c = torch.cumsum(flags.to(torch.int32), -1, dtype=torch.int32)
    cnt = c[..., -1]
    k = torch.arange(1, K + 1, dtype=torch.int32, device=flags.device)
    pos = torch.searchsorted(c, k.expand(c.shape[:-1] + (K,)).contiguous(),
                             side="left").to(torch.int32)
    pos = torch.where(k <= cnt[..., None], pos, fill)
    return pos, cnt


def compact_dense_i(qv, ll_n: int):
    """An intra plane's quantized values qv (n,) int32 as (q8 (n,) int8
    clamped to [-128, 127], pos (K,) int32: the LL positions holding
    |q| > 127, the plane size past them, vals (K,) int32 their values,
    nbig () int32: the values the layout cannot carry, past the LL's
    |q| > 127 and beyond K in the LL; nonzero means overflow), K =
    min(256, ll_n) (dsv1_tpu/ops/hzcc.py compact_dense_i); planes (..., n)
    give each output with the same leading dimensions."""
    n = qv.shape[-1]
    q8 = qv.clamp(-128, 127).to(torch.int8)
    ll = qv[..., :ll_n]
    K = min(256, ll_n)
    pos, cnt = _first_positions(ll.abs() > 127, K, n)
    vals = torch.where(pos < ll_n, ll.gather(-1, pos.clamp(0, ll_n - 1)
                                             .to(torch.int64)), 0) \
        .to(torch.int32)
    nbig = (qv[..., ll_n:].abs() > 127).sum(-1, dtype=torch.int32) \
        + (cnt - K).clamp(min=0)
    return q8, pos, vals, nbig


def sparse_cap_div(quant: int) -> int:
    """Cap divisor of compact_sparse_p for the operating quant: P planes
    are denser at high quality, so the cap widens there."""
    if quant < 160:
        return 16
    if quant < 256:
        return 32
    return 256


def _wrap_i16(x):
    """int32 values to int16 two's complement (the low 16 bits)."""
    return (((x + 0x8000) & 0xFFFF) - 0x8000).to(torch.int16)


def compact_sparse_p(qv, cap_div: int = 256):
    """A P plane's quantized values qv (n,) int32 as its first K nonzeros,
    K = min(n, max(256, n // cap_div)): (runs (K,) the zero run before
    each, u16 bits in an int16 tensor, vals (K,) int16, cnt () int32 the
    plane's nonzero count, ovf () bool: more than K nonzeros, a run over
    0xFFFE or a value past int16). Entries past cnt hold what the JAX
    package's compact_sparse_p gives them, element for element. Planes
    (..., n) give each output with the same leading dimensions."""
    n = qv.shape[-1]
    K = min(n, max(256, n // cap_div))
    pos, cnt = _first_positions(qv != 0, K, n)
    vals = torch.where(pos < n, qv.gather(-1, pos.clamp(0, n - 1)
                                          .to(torch.int64)), 0)
    prev = torch.cat([pos.new_full(pos.shape[:-1] + (1,), -1),
                      pos[..., :-1]], dim=-1)
    runs = pos - prev - 1
    valid = torch.arange(K, device=qv.device) < cnt[..., None]
    ovf = ((cnt > K)
           | (torch.where(valid, runs, 0).amax(-1) > 0xFFFE)
           | (torch.where(valid, vals.abs(), 0).amax(-1) > 0x7FFF))
    return _wrap_i16(runs), _wrap_i16(vals), cnt, ovf


# positions a block of csrc/hzcc.cu's exact compaction takes (kCTile)
COMPACT_TILE = 4096


def _exact_rows(planes, total: int):
    """(rows, positions a row per plane) of compact_exact's planes; raises
    unless there are 3, int32, contiguous, on one device, with the same
    rows, and total (the symbols, which the int32 buffer counts) is under
    2^31 - 1. Positions over all rows may pass 2^31."""
    if len(planes) != 3:
        raise ValueError("compact_exact takes a chunk's 3 planes")
    if not 0 <= total < (1 << 31) - 1:
        raise ValueError("compact_exact takes under 2^31 - 1 symbols")
    rows, ns = None, []
    for q in planes:
        n = q.shape[-1] if q.dim() else 0
        if q.dtype != torch.int32 or not q.is_contiguous() or n < 1 \
                or q.device != planes[0].device:
            raise ValueError("compact_exact takes contiguous int32 planes "
                             "(..., n), n > 0, on one device")
        r = q.numel() // n
        if rows not in (None, r):
            raise ValueError("compact_exact's planes must have the same rows")
        rows = r
        ns.append(n)
    return rows, ns


def compact_exact_plain(planes, total: int):
    """The plain version of compact_exact."""
    _exact_rows(planes, total)
    runs, vals = [], []
    for q in planes:
        q2 = q.reshape(-1, q.shape[-1])
        r, x = (q2 != 0).nonzero(as_tuple=True)
        prev = torch.cat([x.new_full((1,), -1), x[:-1]])
        first = torch.cat([r.new_ones(1, dtype=torch.bool)[:r.numel()],
                           r[1:] != r[:-1]])
        runs.append(x - torch.where(first, -1, prev) - 1)
        vals.append(q2[r, x])
    runs, vals = torch.cat(runs), torch.cat(vals)
    out = torch.zeros(2 * total + 1, dtype=torch.int32, device=runs.device)
    k = min(runs.numel(), total)
    out[:k] = runs[:k].to(torch.int32)
    out[total:total + k] = vals[:k]
    out[2 * total] = runs.numel()
    return out


def compact_exact(planes, total: int):
    """Every symbol of quantized planes, uncapped: the (run, value) pairs
    that runs_from_qvals gives each row, for the chunks whose capped
    compaction overflowed.

    planes: 3 contiguous int32 tensors (..., n_c) of the same rows (a
    chunk's planes c, each row a frame's plane in traversal order);
    total: their nonzero count, which the host read with the capped
    compaction. Returns int32 (2 total + 1,): the runs (u32 bits) of
    plane 0's rows in order, then plane 1's and plane 2's, then the
    values in the same order, then the count the compaction found, which
    `exact_lists` checks against total (where they differ, the lists are
    not defined). CUDA tensors: csrc/hzcc.cu's three launches; CPU
    tensors: the plain version."""
    if not planes[0].is_cuda:
        return compact_exact_plain(planes, total)
    from ..kernels.build import LAUNCHES, launch
    rows, ns = _exact_rows(planes, total)
    dev = planes[0].device
    tiles = rows * sum(-(-n // COMPACT_TILE) for n in ns)
    scratch = torch.empty(2 * tiles, dtype=torch.int64, device=dev)
    out = torch.empty(2 * total + 1, dtype=torch.int32, device=dev)
    launch("dsv1_hzcc_compact", planes[0],
           *[v for q, n in zip(planes, ns) for v in (q.data_ptr(), n)],
           rows, scratch.data_ptr(), tiles, out.data_ptr(), total)
    LAUNCHES["hzcc_compact"] += 3
    return out


def exact_lists(buf: np.ndarray, counts: np.ndarray) -> list:
    """compact_exact's buffer on the host as [plane][row] (runs u32,
    vals i32) views; counts (planes, rows) the nonzero counts it was made
    from. Raises where the compaction found another count."""
    counts = np.asarray(counts, np.int64)
    total = int(counts.sum())
    if buf.size != 2 * total + 1 or int(buf[-1]) != total:
        raise RuntimeError(f"exact compaction found {int(buf[-1])} symbols, "
                           f"the capped compaction counted {total}")
    runs, vals = buf[:total].view(np.uint32), buf[total:2 * total]
    ends = np.cumsum(counts.reshape(-1)).reshape(counts.shape)
    return [[(runs[e - k:e], vals[e - k:e]) for e, k in zip(er, kr)]
            for er, kr in zip(ends.tolist(), counts.tolist())]


def runs_from_qvals(qvals: np.ndarray):
    """(runs, values) symbol stream from quantized traversal values (the
    encoder side of hzcc.c:176-283)."""
    nz = np.flatnonzero(qvals)
    if nz.size == 0:
        return np.zeros(0, np.uint32), np.zeros(0, np.int32)
    prev = np.concatenate(([-1], nz[:-1]))
    runs = (nz - prev - 1).astype(np.uint32)
    return runs, qvals[nz].astype(np.int32)
