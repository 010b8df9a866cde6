"""GOP-parallel encode, CRF or per-frame ABR (mirror of the single-device
paths of dsv1_tpu/parallel/gop.py).

A closed GOP's frames depend on each other only through the recon chain
and the stability accumulators (dsv_encoder.c:639-674). Everything that
depends only on the input frames — pyramids, HME over every P-frame pair
at once, scene-change and forced-intra verdicts — runs first, batched
over the GOP (`GopEncoder.motion`). The host reads the has_ref verdicts
(and, under ABR, the average lumas) once per GOP; then the recon chain
runs frame by frame on the device, and the host packs each picture.
GOPs are encoded one after another, so the stability accumulators,
refresh counter and rate state carried out of one GOP are exactly the
state the reference holds entering the next. Frames are read GOP by
GOP: a long or large input is never held whole. At gop 0 (intra only)
every frame is its own GOP with no HME and no recon, and frames go
through in chunks (`_encode_intra`).

Under ABR the reference's per-frame law (ops/rc.py) picks each frame's
quality from the exact byte size of the picture before it, which
ops/piclen.py computes on the device from the encode core's tensors (the
JAX package's in-scan ABR, `_encode_abr_exact`). The core keeps its
quant-derived scalars as host ints, so the host reads each frame's
quality once (`.item()`): one device sync per frame.

Each GOP's phases run under `torch.profiler.record_function` spans
(`gop.upload`, `gop.motion`, `gop.recon_chain`, `gop.pack`); each span
ends on a host read or a host-only step, so its host time covers its
device work. Inside the recon chain, `gop.rate_read` spans each ABR
frame's law and quality read: its host time is the per-frame sync,
mostly the wait for the previous frame's device work.
tools/torch_profile.py reads them.
"""

from functools import lru_cache
from itertools import islice

import numpy as np
import torch
from torch.profiler import record_function

from ..constants import GOP_INTRA, MAX_QP_BITS, RATE_CONTROL_CRF
from ..models.bitstream import (encode_eos_packet, encode_metadata_packet,
                                set_link_offsets)
from ..models.metadata import Metadata

from ..device import resolve
from ..models.encoder import (MOTION_KEYS, MV_KEYS, EncoderConfig,
                              _stable_update, auto_pyramid_levels,
                              block_geometry, build_encode_core, crf_quant,
                              make_encode_core_traced, make_prep,
                              pack_picture, pyr_layouts, split_row)
from ..ops import frame as fr, piclen, rc
from ..ops.hme import hme_batch
from ..state import EncoderState


class GopEncoder:
    """One closed GOP at a time on one device: `motion()` for the
    input-only work, `encode_gop()` for the recon chain."""

    def __init__(self, subsamp: int, w: int, h: int, G: int, quality: int,
                 do_scd: bool = True, scd_delta: int = 4,
                 intra_thresh: int = 50, stable_refresh: int = 0,
                 pyramid_levels: int = 0, device="cuda"):
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

    def encode_frame(self, st: EncoderState, img0, is_p: bool, mv,
                     quant: int):
        """Stability update + encode core for one frame; advances st.
        Returns (qvals per plane, dcs per plane, stable_blocks)."""
        st.stability, st.refresh_ctr, stable_blocks = _stable_update(
            st.stability, st.refresh_ctr, is_p, mv, self.stable_refresh)
        if is_p:
            margs = tuple(mv[k] for k in MOTION_KEYS)
        else:
            margs = (None,) * 4
        qvals, dcs, recon = self.core(img0, st.ref_recon, is_p, quant,
                                      stable_blocks, *margs)
        st.ref_recon = recon
        st.refresh_ctr += int(is_p)
        return qvals, dcs, stable_blocks

    def encode_gop(self, st: EncoderState, imgs0, mv, has_ref, law=None,
                   forced_i: bool = False):
        """The GOP's recon chain from state st; frame 0 is intra. With
        `law` (ops/rc.py make_abr_law) each frame's quality comes from
        the rate state st.rc, which the frame's exact packed size then
        updates; forced_i says the I frame is a scene cut. Returns
        per-frame host outputs: dicts with qvals, dc, stable, has_ref,
        motion and quant."""
        n = imgs0.shape[0]
        dev_outs, frames = [], []
        for i in range(n):
            is_p = bool(has_ref[i - 1]) if i else False
            mv_i = ({k: mv[k][i - 1] for k in MV_KEYS} if i else None)
            quant = self.quant
            if law is not None:
                # a P slot that lost has_ref is a forced-intra frame
                # (SCD / intra % promotion): the law boosts its quality
                # (dsv_encoder.c:133-141)
                with record_function("gop.rate_read"):
                    q, st.rc = law[0](st.rc, is_p, forced_i if i == 0
                                      else not is_p)
                    quality = int(q.item())   # the one host read per frame
                quant = crf_quant(quality)
            qvals, dcs, stable = self.encode_frame(st, imgs0[i], is_p, mv_i,
                                                   quant)
            if law is not None:
                plen = piclen.picture_len(
                    self.blk_w, self.blk_h, self.nbh, self.nbv, MAX_QP_BITS,
                    stable, is_p, *(mv_i[k] if is_p else None
                                    for k in MOTION_KEYS), qvals, dcs)
                st.rc = law[1](st.rc, is_p, quality, plen)
            dev_outs.append(torch.cat([q.reshape(-1) for q in qvals]
                                      + [torch.stack(dcs).reshape(-1),
                                         stable.to(torch.int32)]))
            frames.append((is_p, mv_i, quant, [q.numel() for q in qvals]))
        host = torch.stack(dev_outs).cpu().numpy()   # one fetch per GOP
        out = []
        for i, (is_p, mv_i, quant, sizes) in enumerate(frames):
            *qv, dc, stable = split_row(host[i],
                                        sizes + [3, self.nbh * self.nbv])
            mvh = ({k: mv_i[k].cpu().numpy() for k in MOTION_KEYS}
                   if is_p else None)
            out.append({"qvals": qv, "dc": dc,
                        "stable": stable.astype(np.uint8),
                        "has_ref": is_p, "mv": mvh, "quant": quant})
        return out


@lru_cache(maxsize=8)
def build_gop_encoder(subsamp: int, w: int, h: int, G: int, quality: int,
                      do_scd: bool = True, scd_delta: int = 4,
                      intra_thresh: int = 50, stable_refresh: int = 0,
                      pyramid_levels: int = 0, device: str = "cuda"):
    """The GOP encoder for one geometry (cached)."""
    return GopEncoder(subsamp, w, h, G, quality, do_scd, scd_delta,
                      intra_thresh, stable_refresh, pyramid_levels, device)


def _packed_gops(frames, G: int):
    """(y, u, v) frames from any iterable -> (first frame number, (n, fsz)
    u8 raw planar rows) per GOP (or chunk) of up to G frames, read as
    they come."""
    it = iter(frames)
    g0 = 0
    while True:
        gop = list(islice(it, G))
        if not gop:
            return
        yield g0, np.stack([fr.np_pack_planes(f) for f in gop])
        g0 += len(gop)


def _encode_intra(frames, meta: Metadata, cfg: EncoderConfig, dev) -> bytes:
    """gop 0 (the JAX package's build_intra_encoder and its gop-0 branch
    of encode_stream_gops): every frame an intra, non-reference picture
    after its own metadata packet; no HME, no recon, every block stable
    (the zeroed accumulators make every block stable,
    dsv_encoder.c:383-393). Frames go through in chunks, one device fetch
    per chunk."""
    w, h, subsamp = meta.width, meta.height, meta.subsamp
    blk_w, blk_h, nbh, nbv = block_geometry(w, h)
    quant = crf_quant(cfg.quality)
    prep = make_prep(subsamp, w, h, 0)
    core = build_encode_core(subsamp, w, h, False)
    stable = torch.ones(nbh * nbv, dtype=torch.uint8, device=dev)
    stable_h = np.ones(nbh * nbv, np.uint8)
    chunk = max(1, min(64, (8 << 20) // max(w * h, 1)))
    meta_pkt = bytes(encode_metadata_packet(meta))
    out = bytearray()
    prev_link = 0
    for f0, rows in _packed_gops(frames, chunk):
        with record_function("gop.upload"):
            packed = torch.from_numpy(rows).to(dev)
        with record_function("gop.intra_core"):
            imgs, _al = prep(fr.split_packed_planes(packed, subsamp, w, h))
            dev_outs = []
            for img in imgs[0]:
                qvals, dcs, _ = core(img, None, False, quant, stable,
                                     None, None, None, None)
                dev_outs.append(torch.cat([q.reshape(-1) for q in qvals]
                                          + [torch.stack(dcs).reshape(-1)]))
            sizes = [q.numel() for q in qvals] + [3]
            host = torch.stack(dev_outs).cpu().numpy()   # one fetch a chunk
        with record_function("gop.pack"):
            for i, row in enumerate(host):
                *qv, dc = split_row(row, sizes)
                pic = pack_picture(f0 + i, blk_w, blk_h, stable_h, False,
                                   False, None, quant, qv, dc, nbh, nbv)
                set_link_offsets(pic, prev_link, len(pic))
                prev_link = len(pic)
                out.extend(meta_pkt)
                out.extend(pic)
    out.extend(encode_eos_packet(prev_link))
    return bytes(out)


def encode_stream_gops(frames, meta: Metadata,
                       cfg: EncoderConfig | None = None, device="cuda", *,
                       abr_mode: str = "exact") -> bytes:
    """Encode (y, u, v) uint8 frames (any iterable, read GOP by GOP) into
    a full .dsv stream, GOP by GOP on `device`. CRF (gop 0 included:
    intra only), or ABR with the reference's per-frame law (abr_mode
    "exact"). Byte-identical to the JAX package's encode_stream_gops for
    the same frames and config. Raises the JAX package's ValueError for
    ABR at gop 0 and for gop > 4096 (the sequential `Encoder` runs
    those), NotImplementedError for abr_mode "gop" and effort > 0."""
    cfg = cfg or EncoderConfig()
    dev = resolve(device)
    abr = cfg.rc_mode != RATE_CONTROL_CRF
    if abr and cfg.gop == GOP_INTRA:
        raise ValueError("GOP-parallel ABR needs gop > 0; "
                         "use models.encoder.Encoder")
    if cfg.gop != GOP_INTRA and cfg.gop > 4096:
        raise ValueError("GOP too long for the device-resident scan; "
                         "use models.encoder.Encoder")
    if abr and abr_mode != "exact":
        raise NotImplementedError(f"abr_mode={abr_mode!r} (GOP-granular "
                                  "ABR) is not ported yet")
    if cfg.effort:
        raise NotImplementedError("effort > 0 is not ported yet")
    if cfg.gop == GOP_INTRA:
        return _encode_intra(frames, meta, cfg, dev)
    w, h, subsamp = meta.width, meta.height, meta.subsamp
    G = cfg.gop
    enc = build_gop_encoder(subsamp, w, h, G, cfg.quality, cfg.do_scd,
                            cfg.scene_change_delta, cfg.intra_pct_thresh,
                            cfg.stable_refresh, cfg.pyramid_levels, str(dev))
    # GOPs run in order: the accumulators, counter and rate state carry
    # across them
    st = EncoderState(
        stability=torch.zeros((enc.nbh * enc.nbv, 2), dtype=torch.int32,
                              device=dev),
        refresh_ctr=0, prev_al=0, ref_recon=None,
        rc=rc.init_state(cfg.quality, dev) if abr else None)
    law = rc.make_abr_law(cfg, meta) if abr else None
    meta_pkt = bytes(encode_metadata_packet(meta))
    out = bytearray()
    prev_link = 0
    for g0, rows in _packed_gops(frames, G):
        with record_function("gop.upload"):
            packed = torch.from_numpy(rows).to(dev)
        with record_function("gop.motion"):
            imgs, al, mv, has_ref = enc.motion(packed)
            # one host read per GOP: the average lumas and the has_ref
            # verdicts
            parts = [al] if has_ref is None else [al, has_ref.to(al.dtype)]
            hv = torch.cat(parts).cpu().numpy()
            al_h, hr = hv[:rows.shape[0]], hv[rows.shape[0]:].astype(bool)
        forced_i = False
        if abr and cfg.do_scd:
            # the GOP's I frame is a scene cut against the previous frame
            # (the zero-initialised luma before frame 0) and so counts as
            # forced intra for the law (dsv_encoder.c:538-554, 133-141)
            forced_i = abs(int(al_h[0]) - st.prev_al) > cfg.scene_change_delta
            st.prev_al = int(al_h[-1])
        with record_function("gop.recon_chain"):
            st.ref_recon = fr.alloc_image(enc.layouts[0], device=dev)
            outs = enc.encode_gop(st, imgs[0], mv, hr, law, forced_i)
        with record_function("gop.pack"):
            out.extend(meta_pkt)
            for i, o in enumerate(outs):
                pic = pack_picture(g0 + i, enc.blk_w, enc.blk_h, o["stable"],
                                   o["has_ref"], True, o["mv"], o["quant"],
                                   o["qvals"], o["dc"], enc.nbh, enc.nbv)
                set_link_offsets(pic, prev_link, len(pic))
                prev_link = len(pic)
                out.extend(pic)
    out.extend(encode_eos_packet(prev_link))
    return bytes(out)
