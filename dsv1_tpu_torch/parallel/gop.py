"""GOP-parallel CRF encode (mirror of the CRF path of dsv1_tpu/parallel/gop.py).

A closed GOP's frames depend on each other only through the recon chain
and the stability accumulators (dsv_encoder.c:639-674). Everything that
depends only on the input frames — pyramids, HME over every P-frame pair
at once, scene-change and forced-intra verdicts — runs first, batched
over the GOP (`GopEncoder.motion`). The host reads the has_ref verdicts
once per GOP; then the recon chain runs frame by frame on the device,
and the host packs each picture. GOPs are encoded one after another, so
the stability accumulators and refresh counter carried out of one GOP
are exactly the state the reference holds entering the next.

Each GOP's phases run under `torch.profiler.record_function` spans
(`gop.upload`, `gop.motion`, `gop.recon_chain`, `gop.pack`); each span
ends on a host read or a host-only step, so its host time covers its
device work. tools/torch_profile.py reads them.
"""

from functools import lru_cache

import numpy as np
import torch
from torch.profiler import record_function

from dsv1_tpu.constants import (GOP_INTRA, MAX_BLOCK_SIZE, MIN_BLOCK_SIZE,
                                MODE_INTER, RATE_CONTROL_CRF, div_round,
                                quant_of_quality)
from dsv1_tpu.models.bitstream import (encode_eos_packet,
                                       encode_metadata_packet,
                                       set_link_offsets)
from dsv1_tpu.models.metadata import Metadata

from ..device import resolve
from ..models.encoder import (EncoderConfig, auto_pyramid_levels,
                              make_encode_core_traced, make_prep,
                              pack_picture, pyr_layouts, size4dim)
from ..ops import frame as fr
from ..ops.hme import hme_batch
from ..state import EncoderState

MV_KEYS = ("mode", "mvx", "mvy", "submask", "lo_tex", "lo_var",
           "high_detail")


def crf_quant(quality: int) -> int:
    """quality2quant CRF tail (dsv_encoder.c:165)."""
    return int(quant_of_quality(quality))


def block_geometry(w: int, h: int):
    blk_w = max(MIN_BLOCK_SIZE, min(size4dim(w) & ~7, MAX_BLOCK_SIZE))
    blk_h = max(MIN_BLOCK_SIZE, min(size4dim(h) & ~7, MAX_BLOCK_SIZE))
    return blk_w, blk_h, div_round(w, blk_w), div_round(h, blk_h)


def _wrap16(x):
    """int16 two's-complement wrap on int32 values (the reference keeps
    the accumulators as int16, dsv_encoder.h:101-106)."""
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def _stable_update(stability, refresh_ctr: int, is_p: bool, mv,
                   stable_refresh: int):
    """Stability accumulator logic (encode_stable_blocks,
    dsv_encoder.c:329-400) on an int32 (nblk, 2) tensor.

    Returns (stability', refresh_ctr', stable_blocks u8: bit0 stable,
    bit1 intra). mv is the frame's motion dict (ignored for I frames)."""
    if refresh_ctr >= stable_refresh:
        refresh_ctr = 0
        stability = torch.zeros_like(stability)
    avgdiv = max(refresh_ctr, 1)

    def avg(s):
        return torch.sign(s) * torch.div(s.abs(), avgdiv,
                                         rounding_mode="floor")

    sx0, sy0 = stability[:, 0], stability[:, 1]
    if is_p:
        inter = mv["mode"].reshape(-1) == MODE_INTER
        sxp = _wrap16(torch.where(
            inter, sx0 + (mv["mvx"].reshape(-1).to(torch.int32).abs() >> 2),
            sx0))
        syp = _wrap16(torch.where(
            inter, sy0 + (mv["mvy"].reshape(-1).to(torch.int32).abs() >> 2),
            sy0))
        lo = (mv["lo_tex"].reshape(-1) != 0) | (mv["lo_var"].reshape(-1) != 0)
        stable = (mv["high_detail"].reshape(-1) != 0) \
            | ((avg(sxp) == 0) & (avg(syp) == 0) & ~lo)
        stable &= inter
        intra_blk = ~inter
        stability = torch.stack([torch.where(lo, 0x3FFF, sxp),
                                 torch.where(lo, 0x3FFF, syp)], dim=1) \
            .to(torch.int32)
    else:
        stable = (avg(sx0) == 0) & (avg(sy0) == 0)
        intra_blk = torch.zeros_like(stable)
    stable_blocks = stable.to(torch.uint8) | (intra_blk.to(torch.uint8) << 1)
    return stability, refresh_ctr, stable_blocks


class GopEncoder:
    """One closed CRF GOP at a time on one device: `motion()` for the
    input-only work, `encode_gop()` for the recon chain."""

    def __init__(self, subsamp: int, w: int, h: int, G: int, quality: int,
                 do_scd: bool = True, scd_delta: int = 4,
                 intra_thresh: int = 50, stable_refresh: int = 0,
                 pyramid_levels: int = 0, device="cpu"):
        self.device = resolve(device)
        self.subsamp, self.w, self.h, self.G = subsamp, w, h, G
        self.blk_w, self.blk_h, self.nbh, self.nbv = block_geometry(w, h)
        self.levels = pyramid_levels or auto_pyramid_levels(
            w, h, self.nbh, self.nbv)
        self.stable_refresh = stable_refresh or max(1, min(G - 1, 14))
        self.do_scd, self.scd_delta = do_scd, scd_delta
        self.intra_thresh = intra_thresh
        self.quant = crf_quant(quality)
        self.layouts = pyr_layouts(subsamp, w, h, self.levels)
        self.prep = make_prep(subsamp, w, h, self.levels)
        self.core = make_encode_core_traced(subsamp, w, h, self.blk_w,
                                            self.blk_h, self.nbh, self.nbv)

    def motion(self, packed, calls: list | None = None):
        """packed: (n, fsz) u8 planar frames of one GOP on the device.
        Returns (images per pyramid level (n, flat), average luma (n,),
        motion dict over the n-1 P slots, has_ref (n-1,) bool). `calls`
        collects the HME kernels' arguments (ops/hme.py hme_batch)."""
        y, u, v = fr.split_packed_planes(packed, self.subsamp, self.w,
                                         self.h)
        imgs, al = self.prep((y, u, v))
        if packed.shape[0] == 1:
            return imgs, al, None, None
        mv = hme_batch([a[1:] for a in imgs], [a[:-1] for a in imgs],
                       self.layouts, self.blk_w, self.blk_h, self.nbh,
                       self.nbv, self.subsamp, self.levels, calls)
        has_ref = mv["intra_pct"] <= self.intra_thresh
        if self.do_scd:
            has_ref &= (al[1:] - al[:-1]).abs() <= self.scd_delta
        return imgs, al, mv, has_ref

    def encode_frame(self, st: EncoderState, img0, is_p: bool, mv):
        """Stability update + encode core for one frame; advances st.
        Returns (qvals per plane, dcs per plane, stable_blocks)."""
        st.stability, st.refresh_ctr, stable_blocks = _stable_update(
            st.stability, st.refresh_ctr, is_p, mv, self.stable_refresh)
        if is_p:
            margs = (mv["mode"], mv["mvx"], mv["mvy"], mv["submask"])
        else:
            margs = (None,) * 4
        qvals, dcs, recon = self.core(img0, st.ref_recon, is_p, self.quant,
                                      stable_blocks, *margs)
        st.ref_recon = recon
        st.refresh_ctr += int(is_p)
        return qvals, dcs, stable_blocks

    def encode_gop(self, st: EncoderState, imgs0, mv, has_ref):
        """The GOP's recon chain from state st (stability accumulators +
        refresh counter); frame 0 is intra. Returns per-frame host
        outputs: dicts with qvals, dc, stable, has_ref and motion."""
        n = imgs0.shape[0]
        dev_outs, frames = [], []
        for i in range(n):
            is_p = bool(has_ref[i - 1]) if i else False
            mv_i = ({k: mv[k][i - 1] for k in MV_KEYS} if i else None)
            qvals, dcs, stable = self.encode_frame(st, imgs0[i], is_p, mv_i)
            dev_outs.append(torch.cat([q.reshape(-1) for q in qvals]
                                      + [torch.stack(dcs).reshape(-1),
                                         stable.to(torch.int32)]))
            frames.append((is_p, mv_i, [q.numel() for q in qvals]))
        host = torch.stack(dev_outs).cpu().numpy()   # one fetch per GOP
        out = []
        for i, (is_p, mv_i, sizes) in enumerate(frames):
            row, off, qv = host[i], 0, []
            for s in sizes:
                qv.append(row[off:off + s])
                off += s
            mvh = ({k: mv_i[k].cpu().numpy() for k in
                    ("mode", "mvx", "mvy", "submask")} if is_p else None)
            out.append({"qvals": qv, "dc": row[off:off + 3],
                        "stable": row[off + 3:].astype(np.uint8),
                        "has_ref": is_p, "mv": mvh})
        return out


@lru_cache(maxsize=8)
def build_gop_encoder(subsamp: int, w: int, h: int, G: int, quality: int,
                      do_scd: bool = True, scd_delta: int = 4,
                      intra_thresh: int = 50, stable_refresh: int = 0,
                      pyramid_levels: int = 0, device: str = "cpu"):
    """The GOP encoder for one geometry (cached)."""
    return GopEncoder(subsamp, w, h, G, quality, do_scd, scd_delta,
                      intra_thresh, stable_refresh, pyramid_levels, device)


def encode_stream_gops(frames, meta: Metadata, cfg: EncoderConfig | None,
                       device) -> bytes:
    """Encode (y, u, v) uint8 frames into a full .dsv stream (CRF, gop >
    0, effort 0), GOP by GOP on `device`. Byte-identical to the JAX
    package's encode_stream_gops for the same frames and config."""
    cfg = cfg or EncoderConfig()
    dev = resolve(device)
    # a config of the JAX package may ask for what the port lacks
    if getattr(cfg, "rc_mode", RATE_CONTROL_CRF) != RATE_CONTROL_CRF:
        raise NotImplementedError("the port encodes CRF only")
    if getattr(cfg, "effort", 0):
        raise NotImplementedError("the port encodes effort 0 only")
    if cfg.gop == GOP_INTRA or cfg.gop > 4096:
        raise NotImplementedError("the port encodes 0 < gop <= 4096 only")
    w, h, subsamp = meta.width, meta.height, meta.subsamp
    G = cfg.gop
    enc = build_gop_encoder(subsamp, w, h, G, cfg.quality, cfg.do_scd,
                            cfg.scene_change_delta, cfg.intra_pct_thresh,
                            cfg.stable_refresh, cfg.pyramid_levels, str(dev))
    # GOPs run in order: the accumulators and counter carry across them
    st = EncoderState(
        stability=torch.zeros((enc.nbh * enc.nbv, 2), dtype=torch.int32,
                              device=dev),
        refresh_ctr=0, prev_al=0, ref_recon=None)
    meta_pkt = bytes(encode_metadata_packet(meta))
    out = bytearray()
    prev_link = 0
    frames = list(frames)
    for g0 in range(0, len(frames), G):
        gop = frames[g0:g0 + G]
        with record_function("gop.upload"):
            packed = np.stack([np.concatenate(
                [np.asarray(p, np.uint8).ravel() for p in f[:3]])
                for f in gop])
            packed = torch.from_numpy(packed).to(dev)
        with record_function("gop.motion"):
            imgs, _al, mv, has_ref = enc.motion(packed)
            hr = has_ref.cpu().numpy() if has_ref is not None else None
        with record_function("gop.recon_chain"):
            st.ref_recon = fr.alloc_image(enc.layouts[0], device=dev)
            outs = enc.encode_gop(st, imgs[0], mv, hr)
        with record_function("gop.pack"):
            out.extend(meta_pkt)
            for i, o in enumerate(outs):
                pic = pack_picture(g0 + i, enc.blk_w, enc.blk_h, o["stable"],
                                   o["has_ref"], True, o["mv"], enc.quant,
                                   o["qvals"], o["dc"], enc.nbh, enc.nbv)
                set_link_offsets(pic, prev_link, len(pic))
                prev_link = len(pic)
                out.extend(pic)
    out.extend(encode_eos_packet(prev_link))
    return bytes(out)
