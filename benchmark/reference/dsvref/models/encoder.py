"""The encoder's building blocks (mirror of dsv1_tpu/models/encoder.py,
copied from the port's plain path; the sequential `Encoder` is not
copied).

`make_prep` turns input planes into the padded image, the luma pyramid
and the smallest level's average luma (for scene-change detection);
`make_encode_core_traced` runs one frame's prediction/residual, forward
transform, quantization with in-loop write-back and recon for all three
planes (encode_picture core, dsv_encoder.c:505-526), or the same for a
batch of frames of one type (the GOP encoder's frames of one frame index
across a chunk's GOPs); `pack_picture` assembles the picture packet on
the host (native/dsvbits.cpp).
"""

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from .. import bits
from ..constants import (FOURCC, MAX_BLOCK_SIZE, MAX_PYRAMID_LEVELS,
                         MAX_QP_BITS, MAX_QUALITY, MIN_BLOCK_SIZE,
                         MODE_INTER, RATE_CONTROL_CRF, VERSION_MINOR,
                         div_round, make_pt, quality_percent,
                         quant_of_quality, round_pow2, round_shift)
from ..ops import bmc, frame as fr, hzcc, sbt
from ..ops.cint import lb2
from ..utils.stats import STATS

MV_KEYS = ("mode", "mvx", "mvy", "submask", "lo_tex", "lo_var",
           "high_detail")
MOTION_KEYS = ("mode", "mvx", "mvy", "submask")


def size4dim(dim: int) -> int:
    """Resolution-based block size (dsv_encoder.c:556-572)."""
    if dim > 1280:
        return MAX_BLOCK_SIZE
    if dim > 1024:
        return 48
    if dim > 704:
        return 32
    if dim > 352:
        return 24
    return MIN_BLOCK_SIZE


def auto_pyramid_levels(w: int, h: int, nbh: int, nbv: int) -> int:
    """Auto pyramid depth (dsv_encoder.c:602-613)."""
    lvls = lb2(min(w, h))
    maxdim = max(nbh, nbv)
    while (1 << lvls) > maxdim:
        lvls -= 1
    return max(3, min(lvls, MAX_PYRAMID_LEVELS))


def block_geometry(w: int, h: int):
    """(blk_w, blk_h, nbh, nbv) of a frame (dsv_encoder.c:556-572)."""
    blk_w = max(MIN_BLOCK_SIZE, min(size4dim(w) & ~7, MAX_BLOCK_SIZE))
    blk_h = max(MIN_BLOCK_SIZE, min(size4dim(h) & ~7, MAX_BLOCK_SIZE))
    return blk_w, blk_h, div_round(w, blk_w), div_round(h, blk_h)


def crf_quant(quality: int) -> int:
    """quality2quant CRF tail (dsv_encoder.c:165)."""
    return int(quant_of_quality(quality))


@dataclass
class EncoderConfig:
    """The encoder's knobs, as the JAX package's EncoderConfig (defaults:
    dsv_enc_init, dsv_encoder.c:696-722). rc_mode picks CRF at `quality`
    or the per-frame ABR law toward `bitrate`; effort 1..3 widens the
    level-0 motion search beyond the reference (ops/hme.py hme_batch)."""
    quality: int = quality_percent(85)
    gop: int = 24
    do_scd: bool = True
    rc_mode: int = RATE_CONTROL_CRF
    rc_high_motion_nudge: bool = True
    bitrate: int = 2**31 - 1
    max_q_step: int = MAX_QUALITY * 1 // 200
    min_quality: int = quality_percent(1)
    max_quality: int = quality_percent(95)
    min_I_frame_quality: int = quality_percent(5)
    intra_pct_thresh: int = 50
    scene_change_delta: int = 4
    stable_refresh: int = 14
    pyramid_levels: int = 0
    effort: int = 0


@lru_cache(maxsize=16)
def pyr_layouts(subsamp: int, w: int, h: int, levels: int):
    outs = [fr.make_layout(subsamp, w, h, True)]
    for i in range(levels):
        outs.append(fr.make_layout(subsamp, round_shift(w, i + 1),
                                   round_shift(h, i + 1), True))
    return tuple(outs)


def make_prep(subsamp: int, w: int, h: int, levels: int):
    """f(planes) -> (images per pyramid level, smallest-level average
    luma). planes: (y, u, v) with any leading batch dims; images are
    (..., flat) u8 (level 0 the full frame).

    At levels 0 (gop 0) the average is the full frame's, where the JAX
    package returns 0: only scene-change detection reads it, and gop 0
    never runs that."""
    layouts = pyr_layouts(subsamp, w, h, levels)

    def f(planes):
        imgs = [fr.image_from_planes(layouts[0], planes)]
        for i in range(levels):
            lay = layouts[i + 1]
            src = fr.plane_view_ext(imgs[-1], layouts[i], 0, 1)
            luma = fr.ds2x_luma(src, lay.planes[0].w, lay.planes[0].h)
            imgs.append(fr.image_from_luma(lay, luma))
        al = fr.avg_luma(fr.plane_view(imgs[-1], layouts[-1], 0))
        return imgs, al

    return f


def coef_geometry(subsamp: int, w: int, h: int, nbh: int, nbv: int):
    """Per-plane coefficient dims + HZCC traversal tables."""
    layout = fr.make_layout(subsamp, w, h, True)
    coef_dims = []
    for c in range(3):
        p = layout.planes[c]
        if c > 0:
            coef_dims.append((round_pow2(p.w, 1), round_pow2(p.h, 1)))
        else:
            coef_dims.append((p.w, p.h))
    tables = [hzcc.build_tables(cw, ch, nbh, nbv) for (cw, ch) in coef_dims]
    return layout, coef_dims, tables


def make_encode_core_traced(subsamp: int, w: int, h: int, blk_w: int,
                            blk_h: int, nbh: int, nbv: int,
                            want_recon: bool = True):
    """f(input_img, ref_recon_img, is_p, quant, stable_blocks, modes, mvx,
    mvy, submask) -> (qvals per plane, dcs per plane, recon image).

    One frame: images (n,), stable_blocks and fields (nbh * nbv) each;
    or C frames of the same type: images (C, n), stable_blocks and fields
    (C, ...), and each output gains the leading C. is_p is a python bool
    (the frame type is known on the host); the prediction is built only
    for P frames. Per frame: the prologue (`bmc.residual_in`, the three
    planes' centred coefficients), then per plane the forward transform,
    the quantization with write-back (`hzcc.encode_plane_core`) and the
    recon (`sbt.inv_sbt_recon`: the inverse transform, the residual add
    and the plane written into the recon image). Without `want_recon`
    the recon is skipped and the recon image is None."""
    layout, coef_dims, tables = coef_geometry(subsamp, w, h, nbh, nbv)

    def f(input_img, ref_recon_img, is_p: bool, quant: int, stable_blocks,
          modes, mvx, mvy, submask):
        batch = input_img.dim() == 2
        if not batch:
            input_img = input_img[None]
            ref_recon_img = (None if ref_recon_img is None
                             else ref_recon_img[None])
            stable_blocks = stable_blocks.reshape(1, -1)
        C = input_img.shape[0]
        qvals, dcs = [], []
        preds = None
        if is_p:
            preds = bmc.compensate_frame(
                ref_recon_img, layout, blk_w, blk_h, nbh, nbv,
                *(x.reshape(C, -1) for x in (modes, mvx, mvy, submask)))
        planes = bmc.residual_in(input_img, layout, coef_dims, preds)
        recon = (torch.zeros((C, layout.total + 2 * layout.margin),
                             dtype=torch.uint8, device=input_img.device)
                 if want_recon else None)
        for c in range(3):
            coefs = sbt.fwd_sbt(planes[c], is_p)
            qv, wb = hzcc.encode_plane_core(coefs, quant, is_p, c,
                                            stable_blocks, tables[c])
            qvals.append(qv)
            dcs.append(coefs[:, 0, 0])
            if not want_recon:
                continue
            sbt.inv_sbt_recon(wb, quant, is_p, c == 0, recon, layout, c,
                              preds[c] if is_p else None)
        STATS["core_p" if is_p else "core_i"] += C
        STATS["core_calls_p" if is_p else "core_calls_i"] += 1
        STATS["core_calls_recon"] += int(want_recon)
        if batch:
            return qvals, dcs, recon
        return ([q[0] for q in qvals], [d[0] for d in dcs],
                None if recon is None else recon[0])

    return f


def pack_picture(fnum: int, blk_w: int, blk_h: int, stable: np.ndarray,
                 has_ref: bool, is_ref: bool, mv: dict | None, quant: int,
                 qvals3, dcs3, nbh: int, nbv: int) -> bytearray:
    """Host-side picture packet assembly (encode_picture,
    dsv_encoder.c:463-536) in one native call; qvals3: per plane, the
    dense quantized values in traversal order or their (runs, vals)
    symbols; dcs3: raw DCs."""
    planes = []
    for ci in range(3):
        q3 = qvals3[ci]
        runs, vals = (q3 if isinstance(q3, tuple)
                      else hzcc.runs_from_qvals(np.asarray(q3)))
        planes.append((runs, vals, int(dcs3[ci])))
    return bits.pack_picture(
        FOURCC, VERSION_MINOR, make_pt(is_ref, has_ref), fnum, blk_w, blk_h,
        nbh, nbv, stable, has_ref,
        mv["mode"].reshape(-1) if has_ref else None,
        mv["mvx"].reshape(-1) if has_ref else None,
        mv["mvy"].reshape(-1) if has_ref else None,
        mv["submask"].reshape(-1) if has_ref else None,
        quant, MAX_QP_BITS, planes)


def _wrap16(x):
    """int16 two's-complement wrap on int32 values (the reference keeps
    the accumulators as int16, dsv_encoder.h:101-106)."""
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def _stable_update(stability, refresh_ctr, is_p, mv, stable_refresh: int):
    """Stability accumulator logic (encode_stable_blocks,
    dsv_encoder.c:329-400) on an int32 (nblk, 2) tensor, refresh_ctr a
    host int and is_p a host bool; or on a batch: stability (k, nblk, 2),
    refresh_ctr and is_p sequences of k host values, the motion fields
    (k, ...).

    Returns (stability', refresh_ctr' (after the reset check, before the
    P frame's increment), stable_blocks u8: bit0 stable, bit1 intra).
    mv is the frame's motion dict (ignored for I frames; None when no
    frame of the batch is P)."""
    if stability.dim() == 2:
        one = None if mv is None else {k: v.reshape(1, -1)
                                       for k, v in mv.items()}
        stab, ctrs, sb = _stable_update(stability[None], [refresh_ctr],
                                        [is_p], one, stable_refresh)
        return stab[0], ctrs[0], sb[0]
    k, dev = stability.shape[0], stability.device
    is_p = [bool(p) for p in is_p]
    reset = [c >= stable_refresh for c in refresh_ctr]
    ctrs = [0 if r else int(c) for r, c in zip(reset, refresh_ctr)]
    divs = [max(c, 1) for c in ctrs]
    if all(reset):
        stability = torch.zeros_like(stability)
    if len(set(divs)) == len(set(is_p)) == len(set(reset)) == 1:
        avgdiv, p_mask = divs[0], None
    else:
        # per-batch-element values: one small host-to-device copy
        sched = torch.tensor([divs, is_p, [not r for r in reset]],
                             dtype=torch.int32).to(dev, non_blocking=True)
        avgdiv = sched[0][:, None]
        p_mask = sched[1][:, None] != 0
        if any(reset) and not all(reset):
            stability = stability * sched[2][:, None, None]

    def avg(s):
        return torch.sign(s) * torch.div(s.abs(), avgdiv,
                                         rounding_mode="floor")

    sx0, sy0 = stability[..., 0], stability[..., 1]
    if any(is_p):
        def fld(name):
            return mv[name].reshape(k, -1)

        inter = fld("mode") == MODE_INTER
        sxp = _wrap16(torch.where(
            inter, sx0 + (fld("mvx").to(torch.int32).abs() >> 2), sx0))
        syp = _wrap16(torch.where(
            inter, sy0 + (fld("mvy").to(torch.int32).abs() >> 2), sy0))
        lo = (fld("lo_tex") != 0) | (fld("lo_var") != 0)
        stable_p = (fld("high_detail") != 0) \
            | ((avg(sxp) == 0) & (avg(syp) == 0) & ~lo)
        stable_p &= inter
        stab_p = torch.stack([torch.where(lo, 0x3FFF, sxp),
                              torch.where(lo, 0x3FFF, syp)], dim=-1) \
            .to(torch.int32)
    if not all(is_p):
        stable_i = (avg(sx0) == 0) & (avg(sy0) == 0)
    if all(is_p):
        stable, intra_blk, stability = stable_p, ~inter, stab_p
    elif not any(is_p):
        stable, intra_blk = stable_i, torch.zeros_like(stable_i)
    else:
        stable = torch.where(p_mask, stable_p, stable_i)
        intra_blk = p_mask & ~inter
        stability = torch.where(p_mask[..., None], stab_p, stability)
    stable_blocks = stable.to(torch.uint8) | (intra_blk.to(torch.uint8) << 1)
    return stability, ctrs, stable_blocks


def split_row(row, sizes):
    """Consecutive pieces of a 1-D array, of the given sizes."""
    out, off = [], 0
    for s in sizes:
        out.append(row[off:off + s])
        off += s
    return out
