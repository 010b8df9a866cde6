"""The encoder (mirror of dsv1_tpu/models/encoder.py).

`make_prep` turns input planes into the padded image, the luma pyramid
and the smallest level's average luma (for scene-change detection);
`make_encode_core_traced` runs one frame's prediction/residual, forward
transform, quantization with in-loop write-back and (optionally) recon
for all three planes (encode_picture core, dsv_encoder.c:505-526), or
the same for a batch of frames of one type (the GOP encoder's frames of
one frame index across a chunk's GOPs: one launch of each kernel);
`pack_picture` assembles the picture packet on the host
(native/dsvbits.cpp). `Encoder` is the sequential encoder: one frame per
call, the GOP, scene-change, rate and stability decisions on the host in
the JAX package's order, the per-pixel work on the device with the
port's kernels at batch 1 (HME, MC, Haar).
"""

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch
from torch.profiler import record_function

from .. import bits
from ..constants import (FOURCC, GOP_INTRA, MAX_BLOCK_SIZE,
                         MAX_PYRAMID_LEVELS, MAX_QP_BITS, MAX_QUALITY,
                         MIN_BLOCK_SIZE, MODE_INTER, BPF_RESET,
                         RATE_CONTROL_CRF, VERSION_MINOR, div_round,
                         make_pt, quality_percent, quant_of_quality,
                         round_pow2, round_shift)

from ..device import resolve
from ..ops import bmc, frame as fr, hzcc, sbt
from ..ops.cint import lb2
from ..ops.hme import hme_batch
from ..state import encoder_tensors
from ..utils.blob import fetch, fetch_dense
from ..utils.stats import STATS
from .bitstream import (encode_eos_packet, encode_metadata_packet,
                        set_link_offsets)
from .metadata import Metadata

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
                            want_recon: bool = True, tile_hook=None):
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
    and the plane written into the recon image); on the card each is one
    launch of a kernel for the whole batch (the inverse a few). Without
    `want_recon` the recon is skipped and the recon image is None (gop
    0: no frame is a reference). tile_hook, if given (parallel/tile.py
    `tile_hook`, the JAX core's `tile_hook`), runs the forward and
    inverse subband transforms in column tiles over a gop x tile mesh
    row's devices, and the recon epilogue after them
    (`sbt.recon_epilogue_plain`); everything else stays on the frame's
    device."""
    layout, coef_dims, tables = coef_geometry(subsamp, w, h, nbh, nbv)
    fwd_sbt = sbt.fwd_sbt if tile_hook is None else tile_hook.fwd

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
            coefs = fwd_sbt(planes[c], is_p)
            qv, wb = hzcc.encode_plane_core(coefs, quant, is_p, c,
                                            stable_blocks, tables[c])
            qvals.append(qv)
            dcs.append(coefs[:, 0, 0])
            if not want_recon:
                continue
            pred = preds[c] if is_p else None
            if tile_hook is None:
                sbt.inv_sbt_recon(wb, quant, is_p, c == 0, recon, layout, c,
                                  pred)
            else:
                sbt.recon_epilogue_plain(
                    tile_hook.inv(wb, quant, is_p, is_luma=(c == 0)), recon,
                    layout, c, pred)
        STATS["core_p" if is_p else "core_i"] += C
        STATS["core_calls_p" if is_p else "core_calls_i"] += 1
        STATS["core_calls_recon"] += int(want_recon)
        if batch:
            return qvals, dcs, recon
        return ([q[0] for q in qvals], [d[0] for d in dcs],
                None if recon is None else recon[0])

    return f


@lru_cache(maxsize=16)
def build_encode_core(subsamp: int, w: int, h: int, want_recon: bool):
    """The encode core for one geometry (cached)."""
    return make_encode_core_traced(subsamp, w, h, *block_geometry(w, h),
                                   want_recon)


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


def quality2quant_abr(st, cfg, meta, is_p: bool, forced_intra: bool) -> int:
    """ABR branch of quality2quant (dsv_encoder.c:70-168) on Python ints
    over mutable rate-control state `st` (attrs: rc_quant, bpf_avg,
    avg_P_frame_q, last_P_frame_over, back_into_range), as the JAX
    package's sequential encoder runs it: no int32 wrap, unlike the
    device law of ops/rc.py. Returns the chosen quality and updates
    st.rc_quant."""
    q = st.rc_quant
    fps = (meta.fps_num << 5) // meta.fps_den or 1
    needed_bpf = ((cfg.bitrate << 5) // fps) >> 3
    bpf = st.bpf_avg or needed_bpf
    dir_ = -1 if (bpf - needed_bpf) > 0 else 1
    delta = (abs(bpf - needed_bpf) << 9) // needed_bpf
    if dir_ == 1:
        delta *= 2
    nudged = False
    if cfg.rc_high_motion_nudge:
        if is_p:
            if st.last_P_frame_over:
                delta = (delta + 1) * 2
                dir_ = -1
                nudged = True
            elif st.back_into_range:
                delta = (delta + 1) * 2
                dir_ = 1
                nudged = True
        elif st.back_into_range:
            delta = (delta + 1) * 2
            dir_ = 1
            nudged = True
    delta = (q * delta) >> 9
    cfg.max_q_step = max(1, min(cfg.max_q_step, MAX_QUALITY))
    cap = cfg.max_q_step * 16 if nudged else cfg.max_q_step
    delta = min(delta, cap)
    q += delta * dir_
    low_p = st.avg_P_frame_q - quality_percent(4)
    low_p = max(cfg.min_quality, min(low_p, cfg.max_quality))
    minq = low_p if is_p else cfg.min_I_frame_quality
    if forced_intra:
        if q < quality_percent(60):
            q += quality_percent(15)
        elif q < quality_percent(70):
            q += quality_percent(8)
        elif q < quality_percent(75):
            q += quality_percent(3)
        q = max(0, min(q, cfg.max_quality - quality_percent(5)))
    q = max(minq, min(q, cfg.max_quality))
    q = max(0, min(q, MAX_QUALITY))
    st.rc_quant = q
    return q


def rc_stats_update_abr(st, cfg, meta, is_p: bool, used_quality: int,
                        pic_len: int):
    """ABR statistics update (dsv_enc, dsv_encoder.c:816-848) on Python
    ints over mutable state `st` (attrs: bpf_total, bpf_reset, bpf_avg,
    total_P_frame_q, avg_P_frame_q, last_P_frame_over,
    back_into_range)."""
    st.bpf_total += pic_len
    st.bpf_reset += 1
    if is_p:
        st.total_P_frame_q += used_quality
        st.avg_P_frame_q = st.total_P_frame_q // st.bpf_reset
        fps = (meta.fps_num << 5) // meta.fps_den or 1
        needed_bpf = ((cfg.bitrate << 5) // fps) >> 3
        went_under = pic_len < (needed_bpf * 3 // 4)
        needed_bpf = needed_bpf * 7 // 8
        went_over = pic_len > needed_bpf
        st.back_into_range = int(st.last_P_frame_over and went_under)
        st.last_P_frame_over = int(went_over)
    else:
        st.last_P_frame_over = 0
        st.back_into_range = 0
    st.bpf_avg = st.bpf_total // st.bpf_reset
    if st.bpf_reset >= BPF_RESET:
        st.bpf_total = st.bpf_avg
        st.total_P_frame_q //= st.bpf_reset
        st.bpf_reset = 1


def split_row(row, sizes):
    """Consecutive pieces of a 1-D array, of the given sizes."""
    out, off = [], 0
    for s in sizes:
        out.append(row[off:off + s])
        off += s
    return out


class Encoder:
    """The sequential encoder (dsv1_tpu/models/encoder.py Encoder; the
    reference API, dsv_encoder.h:112-121): `start`, `encode` one frame
    at a time, `force_metadata`, `end_of_stream`, checkpoint and resume.

    The decisions run on the host in the JAX package's order; the
    per-pixel work runs on `device` with the port's kernels at batch 1.
    Per frame the host reads the device at most twice: after prep + HME
    (average luma, intra %, the motion fields) and after the core (the
    quantized planes, compacted on the device, DCs and stable blocks;
    the dense planes too when the compaction overflowed). `state_dict`
    holds host data with the JAX package's keys and dtypes, so a JAX
    encoder's state resumes here and the other way round."""

    _STATE_SCALARS = (
        "rc_quant", "bpf_total", "bpf_reset", "bpf_avg", "total_P_frame_q",
        "avg_P_frame_q", "last_P_frame_over", "back_into_range", "next_fnum",
        "prev_gop", "prev_avg_luma", "refresh_ctr", "prev_link",
        "_force_meta", "_levels")

    def __init__(self, meta: Metadata, config: EncoderConfig | None = None,
                 device="cuda"):
        self.device = resolve(device)
        self.meta = meta
        self.cfg = config or EncoderConfig()
        # dynamic state (dsv_encoder.h:83-110)
        self.rc_quant = 0
        self.bpf_total = 0
        self.bpf_reset = 0
        self.bpf_avg = 0
        self.total_P_frame_q = 0
        self.avg_P_frame_q = 0
        self.last_P_frame_over = 0
        self.back_into_range = 0
        self.next_fnum = 0
        self.prev_gop = -1
        self.prev_avg_luma = 0
        self.refresh_ctr = 0
        self.prev_link = 0
        self._force_meta = False
        self._levels = self.cfg.pyramid_levels
        self.stability = None       # (nblk, 2) int32 tensor, int16 values
        self.stable_blocks = None   # (nblk,) u8, the last frame's
        self._ref_recon = None      # flat image on the device (MC reference)
        self._ref_pyr = None        # images per level (HME reference)
        self.blk_w, self.blk_h, self.nbh, self.nbv = block_geometry(
            meta.width, meta.height)

    def start(self):
        """dsv_enc_start (dsv_encoder.c:724-734)."""
        c = self.cfg
        c.quality = max(0, min(c.quality, MAX_QUALITY))
        if c.rc_mode != RATE_CONTROL_CRF:
            self.rc_quant = c.quality
            self.avg_P_frame_q = c.quality * 4 // 5
        self._force_meta = True

    def force_metadata(self):
        """Make the next frame a GOP start: its picture is intra and a
        metadata packet precedes it (dsv_enc_force_metadata,
        dsv_encoder.c:760-763)."""
        self._force_meta = True

    def _quality2quant(self, is_p: bool, forced_intra: bool) -> int:
        """quality2quant (dsv_encoder.c:70-168)."""
        c = self.cfg
        if c.rc_mode != RATE_CONTROL_CRF:
            q = quality2quant_abr(self, c, self.meta, is_p, forced_intra)
        else:
            q = c.quality
            self.rc_quant = q
        return crf_quant(q)

    def _motion(self, imgs, al, levels: int, calls):
        """HME of this frame's pyramid against the previous frame's input
        pyramid at B = 1, and the frame's first host read: (average luma,
        intra %, host motion fields, device motion dict)."""
        layouts = pyr_layouts(self.meta.subsamp, self.meta.width,
                              self.meta.height, levels)
        # [None] views keep each image's start, so the planes stay on the
        # 4-byte words the kernels load
        mv = hme_batch([a[None] for a in imgs],
                       [a[None] for a in self._ref_pyr], layouts,
                       self.blk_w, self.blk_h, self.nbh, self.nbv,
                       self.meta.subsamp, levels, calls, self.cfg.effort)
        nblk = self.nbh * self.nbv
        STATS["hme_calls_wide" if self.cfg.effort else "hme_calls"] += 1
        host = torch.cat([al.reshape(1).to(torch.int32),
                          mv["intra_pct"].reshape(1).to(torch.int32)]
                         + [mv[k].reshape(-1).to(torch.int32)
                            for k in MOTION_KEYS]).cpu().numpy()
        mv_h = dict(zip(MOTION_KEYS, split_row(host[2:], [nblk] * 4)))
        return int(host[0]), int(host[1]), mv_h, mv

    def encode(self, planes, calls: list | None = None):
        """Encode one (y, u, v) frame; returns its packets (dsv_enc).
        `calls` collects the HME kernels' arguments (ops/hme.py
        hme_batch)."""
        meta, c, dev = self.meta, self.cfg, self.device
        w, h, subsamp = meta.width, meta.height, meta.subsamp
        nblk = self.nbh * self.nbv
        fnum = self.next_fnum
        self.next_fnum += 1
        if self._levels == 0:
            self._levels = auto_pyramid_levels(w, h, self.nbh, self.nbv)
        intra_only = c.gop == GOP_INTRA
        levels = 0 if intra_only else self._levels
        gop_start = self._force_meta or (self.prev_gop + c.gop) <= fnum
        if gop_start:
            self.prev_gop = fnum
            self._force_meta = False

        with record_function("seq.motion"):
            packed = torch.from_numpy(fr.np_pack_planes(planes)).to(dev)
            imgs, al_d = make_prep(subsamp, w, h, levels)(
                fr.split_packed_planes(packed, subsamp, w, h))
            mv = mv_h = None
            al = intra_pct = 0
            if not intra_only and not gop_start and self._ref_pyr is not None:
                # HME runs before the SCD verdict is known; on a scene cut
                # its fields are dropped (as in the JAX package)
                al, intra_pct, mv_h, mv = self._motion(imgs, al_d, levels,
                                                       calls)
            elif not intra_only and c.do_scd:
                al = int(al_d)

        if intra_only:
            is_ref = has_ref = forced_intra = False
        else:
            is_ref, has_ref, forced_intra = True, not gop_start, False
            if c.do_scd:
                # on a GOP-start frame too: forced_intra boosts ABR
                if abs(self.prev_avg_luma - al) > c.scene_change_delta:
                    has_ref = False
                    forced_intra = True
                self.prev_avg_luma = al
        if has_ref and intra_pct > c.intra_pct_thresh:
            has_ref = False
            forced_intra = True

        quant = self._quality2quant(has_ref, forced_intra)
        with record_function("seq.core"):
            if self.stability is None:
                self.stability = torch.zeros((nblk, 2), dtype=torch.int32,
                                             device=dev)
            self.stability, self.refresh_ctr, stable = _stable_update(
                self.stability, self.refresh_ctr, has_ref, mv,
                c.stable_refresh)
            want_recon = is_ref   # no frame of gop 0 is a reference
            core = build_encode_core(subsamp, w, h, want_recon)
            margs = (tuple(mv[k][0] for k in MOTION_KEYS) if has_ref
                     else (None,) * 4)
            qvals, dcs, recon = core(imgs[0], self._ref_recon, has_ref,
                                     quant, stable, *margs)
            qv, dc, stable_h = self._compacted(qvals, dcs, stable, has_ref,
                                               quant)
            self.stable_blocks = stable_h
        if want_recon:
            self._ref_recon = recon
            self._ref_pyr = imgs

        with record_function("seq.pack"):
            picture = pack_picture(fnum, self.blk_w, self.blk_h,
                                   self.stable_blocks, has_ref, is_ref,
                                   mv_h if has_ref else None, quant, qv, dc,
                                   self.nbh, self.nbv)
        packets = [encode_metadata_packet(meta)] if gop_start else []
        packets.append(picture)
        if has_ref:
            self.refresh_ctr += 1
        if c.rc_mode != RATE_CONTROL_CRF:
            rc_stats_update_abr(self, c, meta, has_ref, self.rc_quant,
                                len(picture))
        set_link_offsets(picture, self.prev_link, len(picture))
        self.prev_link = len(picture)
        return packets

    def _compacted(self, qvals, dcs, stable, has_ref: bool, quant: int):
        """The frame's one host read: its planes compacted on the device
        (a P frame's as capped (run, value) lists, cap from the quant;
        an intra frame's as dense int8 plus the LL's large values), DCs
        and stable blocks. Returns (per-plane (runs, vals) symbols, DCs,
        stable blocks); a frame whose compaction overflowed reads its
        dense planes instead (the JAX package's _uncompact)."""
        geo = coef_geometry(self.meta.subsamp, self.meta.width,
                            self.meta.height, self.nbh, self.nbv)[2]
        parts = {"dc": torch.stack(dcs).to(torch.int32), "stable": stable}
        names = ("runs", "vals", "cnt", "bad") if has_ref \
            else ("q8", "pos", "vals", "bad")
        for c, qv in enumerate(qvals):
            if has_ref:
                comp = hzcc.compact_sparse_p(qv, hzcc.sparse_cap_div(quant))
            else:
                comp = hzcc.compact_dense_i(qv, hzcc.ll_size(geo[c]))
            parts.update({f"{k}{c}": t for k, t in zip(names, comp)})
        host = fetch(parts)
        if any(host[f"bad{c}"] > 0 for c in range(3)):
            STATS["overflow_redos"] += 1
            qv = split_row(fetch_dense([qvals])[0], [t.n for t in geo])
        elif has_ref:
            qv = [(host[f"runs{c}"][:host[f"cnt{c}"]].view(np.uint16)
                   .astype(np.uint32),
                   host[f"vals{c}"][:host[f"cnt{c}"]].astype(np.int32))
                  for c in range(3)]
        else:
            qv = [bits.runs_from_dense8(host[f"q8{c}"], host[f"pos{c}"],
                                        host[f"vals{c}"]) for c in range(3)]
        return qv, host["dc"], host["stable"].astype(np.uint8)

    def end_of_stream(self) -> bytearray:
        """dsv_enc_end_of_stream (dsv_encoder.c:766-778)."""
        pkt = encode_eos_packet(self.prev_link)
        self.prev_link = 0
        return pkt

    def state_dict(self) -> dict:
        """The inter-frame state as host data, with the JAX package's
        keys and dtypes: the DSV_ENCODER scalars, `stability` int16
        (nblk, 2), `stable_blocks` u8, `ref_recon` and `ref_pyr` as flat
        u8 images in the shared frame layout (ops/frame.py)."""
        s = {k: getattr(self, k) for k in self._STATE_SCALARS}
        s["stability"] = (None if self.stability is None else
                          self.stability.cpu().numpy().astype(np.int16))
        s["stable_blocks"] = (None if self.stable_blocks is None
                              else self.stable_blocks.copy())
        s["ref_recon"] = (None if self._ref_recon is None
                          else self._ref_recon.cpu().numpy().copy())
        s["ref_pyr"] = (None if self._ref_pyr is None
                        else [x.cpu().numpy().copy() for x in self._ref_pyr])
        return s

    def load_state_dict(self, s: dict):
        """Resume from a state_dict() of this class or of the JAX
        package's Encoder; the continuation is byte-identical to an
        uninterrupted encode."""
        for k in self._STATE_SCALARS:
            setattr(self, k, s[k])
        self.stable_blocks = (None if s["stable_blocks"] is None
                              else np.array(s["stable_blocks"], np.uint8))
        self.stability, self._ref_recon, self._ref_pyr = encoder_tensors(
            s, self.device)

    def encode_stream(self, frames) -> bytes:
        """Encode an iterable of (y, u, v) frames into a full .dsv
        stream."""
        out = bytearray()
        for planes in frames:
            for pkt in self.encode(planes):
                out += pkt
        out += self.end_of_stream()
        return bytes(out)
