"""Encoder building blocks (mirror of parts of dsv1_tpu/models/encoder.py).

`make_prep` turns input planes into the padded image, the luma pyramid
and the smallest level's average luma (for scene-change detection);
`make_encode_core_traced` runs one frame's prediction/residual, forward
transform, quantization with in-loop write-back and recon for all three
planes (encode_picture core, dsv_encoder.c:505-526); `pack_picture`
assembles the picture packet on the host (native/dsvbits.cpp).
"""

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from .. import bits
from ..constants import (FOURCC, MAX_BLOCK_SIZE, MAX_PYRAMID_LEVELS,
                         MAX_QP_BITS, MAX_QUALITY, MIN_BLOCK_SIZE,
                         RATE_CONTROL_CRF, VERSION_MINOR, make_pt,
                         quality_percent, round_pow2, round_shift)

from ..ops import bmc, frame as fr, hzcc, sbt
from ..ops.cint import lb2


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


@dataclass
class EncoderConfig:
    """The encoder's knobs, as the JAX package's EncoderConfig (defaults:
    dsv_enc_init, dsv_encoder.c:696-722). rc_mode picks CRF at `quality`
    or the per-frame ABR law toward `bitrate`; the port encodes effort 0
    only."""
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
    (..., flat) u8 (level 0 the full frame)."""
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
                            blk_h: int, nbh: int, nbv: int):
    """f(input_img, ref_recon_img, is_p, quant, stable_blocks, modes, mvx,
    mvy, submask) -> (qvals per plane, dcs per plane, recon image).

    is_p is a python bool (the frame type is known on the host); the
    prediction is built only for P frames."""
    layout, coef_dims, tables = coef_geometry(subsamp, w, h, nbh, nbv)

    def f(input_img, ref_recon_img, is_p: bool, quant: int, stable_blocks,
          modes, mvx, mvy, submask):
        qvals, dcs, recon_planes = [], [], []
        for c in range(3):
            p = layout.planes[c]
            cw, ch = coef_dims[c]
            src_ext = fr.plane_view_ext(input_img, layout, c, cw - p.w)
            src_core = src_ext[:p.h, :p.w]
            if is_p:
                pred = bmc.compensate_plane(ref_recon_img, layout, c, blk_w,
                                            blk_h, nbh, nbv, modes, mvx, mvy,
                                            submask)
                core = bmc.sub_residual(src_core, pred)
            else:
                core = src_core
            coefs = torch.zeros((ch, cw), dtype=torch.int32,
                                device=input_img.device)
            coefs[:p.h, :p.w] = core.to(torch.int32) - 128
            if cw > p.w:
                # p2sbc reads the replicated border column (original edge)
                coefs[:p.h, p.w:cw] = src_ext[:p.h, p.w:cw].to(torch.int32) \
                    - 128
            coefs = sbt.fwd_sbt(coefs, is_p)
            qv, wb = hzcc.encode_plane_core(coefs, quant, is_p, c,
                                            stable_blocks, tables[c])
            qvals.append(qv)
            dcs.append(coefs[0, 0])
            rp = sbt.coefs_to_plane(
                sbt.inv_sbt(wb, quant, is_p, is_luma=(c == 0)))[:p.h, :p.w]
            if is_p:
                rp = bmc.add_residual(pred, rp)
            recon_planes.append(rp)
        return qvals, dcs, fr.image_from_planes(layout, recon_planes)

    return f


def pack_picture(fnum: int, blk_w: int, blk_h: int, stable: np.ndarray,
                 has_ref: bool, is_ref: bool, mv: dict | None, quant: int,
                 qvals3, dcs3, nbh: int, nbv: int) -> bytearray:
    """Host-side picture packet assembly (encode_picture,
    dsv_encoder.c:463-536) in one native call; qvals3: per-plane dense
    quantized values in traversal order, dcs3: raw DCs."""
    planes = []
    for ci in range(3):
        runs, vals = hzcc.runs_from_qvals(np.asarray(qvals3[ci]))
        planes.append((runs, vals, int(dcs3[ci])))
    return bits.pack_picture(
        FOURCC, VERSION_MINOR, make_pt(is_ref, has_ref), fnum, blk_w, blk_h,
        nbh, nbv, stable, has_ref,
        mv["mode"].reshape(-1) if has_ref else None,
        mv["mvx"].reshape(-1) if has_ref else None,
        mv["mvy"].reshape(-1) if has_ref else None,
        mv["submask"].reshape(-1) if has_ref else None,
        quant, MAX_QP_BITS, planes)
