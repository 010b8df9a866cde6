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
"""

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


def frame_quants(q: int, is_p: bool, plane_idx: int):
    """(qp_ll, qp0, qp1, qp2_shift, qp2h_shift) for one plane
    (hzcc.c:50-57,199-208)."""
    qf = min(q, CHROMA_LIMIT) if plane_idx > 0 else q
    qp_ll = get_quant(qf, is_p, 0)
    qp1 = get_quant(qf, is_p, 1)
    qp2 = lb2(get_quant(qf, is_p, 2))
    qp2h = min(max(qp2 - (QP_P if is_p else QP_I), 1), 24)
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
    """(sh, sw) stability flags of a band's positions."""
    dev = stable2d.device
    return stable2d.index_select(0, torch.as_tensor(bj, device=dev)) \
        .index_select(1, torch.as_tensor(bi, device=dev))


def _qparam(qp0, qp1, lvl: int, st):
    return tmq4pos(qp0 if lvl == 0 else qp1, st)


def encode_plane_core(coefs, q: int, is_p: bool, plane_idx: int,
                      stable_blocks, tables: TraversalTables):
    """Quantize + in-loop write-back (hzcc_enc, hzcc.c:138-293).

    coefs: (H, W) int32 from fwd_sbt. Returns (qvals[N] quantized values
    in traversal order, recon coefs with the dequantized write-back and
    the raw DC restored)."""
    work = coefs.to(torch.int32).clone()
    dc = work[0, 0].clone()
    work[0, 0] = 0  # hzcc.c:171 src[0] = 0
    qp_ll, qp0, qp1, qp2, qp2h = frame_quants(q, is_p, plane_idx)
    stable2d = stable_blocks.to(torch.int32).reshape(tables.nbv, tables.nbh)
    qparts = []
    for (lvl, oy, ox, sh, sw, bj, bi) in tables.segs:
        vals = work[oy:oy + sh, ox:ox + sw]
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
        work[oy:oy + sh, ox:ox + sw] = torch.where(qv == 0, 0, wb)
        qparts.append(qv.reshape(-1))
    work[0, 0] = dc  # dsv_encode_plane restores the raw DC
    return torch.cat(qparts), work


def dequant_plane_grid(qgrid, dc: int, q: int, is_p: bool, plane_idx: int,
                       stable_blocks, tables: TraversalTables):
    """Dequantize a grid of quantized values (decode side of hzcc_dec,
    hzcc.c:296-435); qgrid is (H, W) in grid order, band aliases already
    resolved last-wins by the parser. dc: the raw DC."""
    qgrid = qgrid.to(torch.int32)
    qp_ll, qp0, qp1, qp2, qp2h = frame_quants(q, is_p, plane_idx)
    stable2d = stable_blocks.to(torch.int32).reshape(tables.nbv, tables.nbh)
    out = torch.zeros_like(qgrid)
    for (lvl, oy, ox, sh, sw, bj, bi) in tables.segs:
        vals = qgrid[oy:oy + sh, ox:ox + sw]
        if lvl == -1:
            dq = dequant_lo(vals, qp_ll)
        else:
            st = _band_stable(stable2d, bj, bi)
            if lvl < MAXLVL - 1:
                dq = dequant_lo(vals, _qparam(qp0, qp1, lvl, st))
            else:
                dq = dequant_hi(vals, torch.where(st != 0, qp2h, qp2))
        out[oy:oy + sh, ox:ox + sw] = torch.where(vals == 0, 0, dq)
    out[0, 0] = dc
    return out


def runs_from_qvals(qvals: np.ndarray):
    """(runs, values) symbol stream from quantized traversal values (the
    encoder side of hzcc.c:176-283)."""
    nz = np.flatnonzero(qvals)
    if nz.size == 0:
        return np.zeros(0, np.uint32), np.zeros(0, np.int32)
    prev = np.concatenate(([-1], nz[:-1]))
    runs = (nz - prev - 1).astype(np.uint32)
    return runs, qvals[nz].astype(np.int32)
