"""GOP-parallel encode, CRF, per-frame ABR or GOP-granular ABR (mirror of
the single-device paths of dsv1_tpu/parallel/gop.py).

A closed GOP's frames depend on each other only through the recon chain
and the stability accumulators (dsv_encoder.c:639-674). Everything that
depends only on the input frames — pyramids, HME over every P-frame pair
at once, scene-change and forced-intra verdicts — runs first, batched
over the GOP (`GopEncoder.motion`). The host reads the has_ref verdicts
(and, under ABR, the average lumas) once per GOP; then the recon chain
runs frame by frame on the device. Each frame's quantized planes are
compacted there (ops/hzcc.py: the I frame as dense int8 plus the LL's
large values, each P frame as a capped (run, value) list), and the host
reads the GOP's compacted planes, DCs, stable blocks and motion fields
in one copy (`GopOutput`) and packs the whole GOP in one native call
(bits.pack_chunk). When a cap overflows, the host reads that GOP's dense
planes, still on the device, and packs it picture by picture: the same
bytes (`STATS["overflow_redos"]` counts these GOPs).
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

With abr_mode "gop" (`_encode_gop_abr`) each GOP has one quality, which
a host model of the rate-quality curve (`_AbrState`) sets from the sizes
of the GOPs packed before it. The JAX package pipelines its GOPs, so a
GOP's quality is set when the GOP is dispatched, before the GOPs ahead
of it are packed; the port replays that schedule on the host
(`_pipelined`), and so gives the same bytes. The first GOP whose
compacted planes fit their caps is packed as a trial, the model
corrected, and the GOP encoded again from the state it started from.

Each GOP's phases run under `torch.profiler.record_function` spans
(`gop.upload`, `gop.motion`, `gop.recon_chain`, `gop.pack`); each span
ends on a host read or a host-only step, so its host time covers its
device work. Inside the recon chain, `gop.rate_read` spans each ABR
frame's law and quality read: its host time is the per-frame sync,
mostly the wait for the previous frame's device work.
tools/torch_profile.py reads them.
"""

import math
import os
from collections import defaultdict
from functools import lru_cache
from itertools import islice

import numpy as np
import torch
from torch.profiler import record_function

from .. import bits
from ..constants import (FOURCC, GOP_INTRA, MAX_QP_BITS, MAX_QUALITY,
                         RATE_CONTROL_CRF, VERSION_MINOR, quant_of_quality)
from ..models.bitstream import (encode_eos_packet, encode_metadata_packet,
                                set_link_offsets)
from ..models.metadata import Metadata

from ..device import resolve
from ..models.encoder import (MOTION_KEYS, MV_KEYS, EncoderConfig,
                              _stable_update, auto_pyramid_levels,
                              block_geometry, build_encode_core,
                              coef_geometry, crf_quant,
                              make_encode_core_traced, make_prep,
                              pack_picture, pyr_layouts, split_row)
from ..ops import frame as fr, hzcc, piclen, rc
from ..ops.hme import hme_batch
from ..state import EncoderState
from ..utils.blob import fetch, fetch_dense
from ..utils.stats import STATS


class GopOutput:
    """One GOP's encoder output on the host, read from the device in one
    copy: the compacted planes (`parts`, ops/hzcc.py layouts), the
    per-frame quants and, when a compaction cap overflowed, the dense
    planes. `pack` assembles the GOP's packets."""

    def __init__(self, enc, parts: dict, has_ref, quants, dense):
        self.enc, self.parts, self.quants = enc, parts, quants
        self.n = len(quants)
        self.has_ref = (np.zeros(0, bool) if has_ref is None
                        else np.asarray(has_ref, bool))
        self.dense = dense     # (n, N) int32, or None
        self.overflow = dense is not None

    def _p_arrays(self):
        """The P frames' fields as pack_chunk takes them, (1, n-1, ...)."""
        h = self.parts
        if self.n == 1:
            return _no_p_arrays(1)
        return ([h[f"p_runs{c}"].view(np.uint16)[None] for c in range(3)],
                [h[f"p_vals{c}"][None] for c in range(3)],
                [h["p_cnt"][:, c][None] for c in range(3)],
                h["p_dc"][None], self.has_ref.astype(np.uint8)[None],
                h["p_mode"][None], h["p_mvx"][None], h["p_mvy"][None],
                h["p_submask"][None], h["p_stable"][None])

    def pack(self, meta_pkt: bytes, fnum0: int, prev_link: int,
             n_real: int | None = None):
        """(the GOP's metadata packet and its first n_real pictures as
        bytes, the new prev_link); fnum0 is the GOP's first frame
        number."""
        e, h = self.enc, self.parts
        n_real = self.n if n_real is None else n_real
        if not self.overflow:
            return bits.pack_chunk(
                FOURCC, VERSION_MINOR, e.blk_w, e.blk_h, e.nbh, e.nbv,
                np.asarray(self.quants, np.int32)[None], MAX_QP_BITS,
                meta_pkt, 1, self.n, 0, 1, n_real, fnum0, 1,
                [h[f"i_q8{c}"][None] for c in range(3)],
                [h[f"i_pos{c}"][None] for c in range(3)],
                [h[f"i_vals{c}"][None] for c in range(3)],
                h["i_dc"][None], h["i_stable"][None], *self._p_arrays(),
                prev_link)
        out = bytearray(meta_pkt)
        for i in range(n_real):
            is_p = bool(self.has_ref[i - 1]) if i else False
            mv = ({k: h[f"p_{k}"][i - 1] for k in MOTION_KEYS} if is_p
                  else None)
            stable = h["p_stable"][i - 1] if i else h["i_stable"]
            dc = h["p_dc"][i - 1] if i else h["i_dc"]
            pic = pack_picture(fnum0 + i, e.blk_w, e.blk_h, stable, is_p,
                               True, mv, self.quants[i],
                               split_row(self.dense[i], e.plane_sizes), dc,
                               e.nbh, e.nbv)
            set_link_offsets(pic, prev_link, len(pic))
            prev_link = len(pic)
            out.extend(pic)
        return bytes(out), prev_link


def picture_sizes(pkt: bytes, meta_len: int) -> list:
    """Byte sizes of the pictures of one packed GOP (its metadata packet
    first), read from each picture's next-link field at byte 10."""
    sizes, off = [], meta_len
    while off < len(pkt):
        sizes.append(int.from_bytes(pkt[off + 10:off + 14], "big"))
        off += sizes[-1]
    return sizes


class GopEncoder:
    """One closed GOP at a time on one device: `motion()` for the
    input-only work, `encode_gop()` for the recon chain."""

    def __init__(self, subsamp: int, w: int, h: int, G: int, quality: int,
                 do_scd: bool = True, scd_delta: int = 4,
                 intra_thresh: int = 50, stable_refresh: int = 0,
                 pyramid_levels: int = 0, device="cuda",
                 cap_quality: int | None = None, effort: int = 0):
        self.device = resolve(device)
        self.effort = effort
        self.subsamp, self.w, self.h, self.G = subsamp, w, h, G
        self.blk_w, self.blk_h, self.nbh, self.nbv = block_geometry(w, h)
        self.levels = pyramid_levels or auto_pyramid_levels(
            w, h, self.nbh, self.nbv)
        self.stable_refresh = stable_refresh or max(1, min(G - 1, 14))
        self.do_scd, self.scd_delta = do_scd, scd_delta
        self.intra_thresh = intra_thresh
        self.quant = crf_quant(quality)
        # the P cap is sized to the highest quality the encode can reach:
        # under ABR the rate law's upper bound (cap_quality)
        self.cap_div = hzcc.sparse_cap_div(crf_quant(
            quality if cap_quality is None else max(quality, cap_quality)))
        tables = coef_geometry(subsamp, w, h, self.nbh, self.nbv)[2]
        self.ll_sizes = [hzcc.ll_size(t) for t in tables]
        self.plane_sizes = [t.n for t in tables]
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
        STATS["hme_calls_wide" if self.effort else "hme_calls"] += 1
        mv = hme_batch([a[1:] for a in imgs], [a[:-1] for a in imgs],
                       self.layouts, self.blk_w, self.blk_h, self.nbh,
                       self.nbv, self.subsamp, self.levels, calls,
                       self.effort)
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
        STATS["core_p" if is_p else "core_i"] += 1
        st.ref_recon = recon
        st.refresh_ctr += int(is_p)
        return qvals, dcs, stable_blocks

    def encode_gop(self, st: EncoderState, imgs0, mv, has_ref, law=None,
                   forced_i: bool = False, quants=None) -> GopOutput:
        """The GOP's recon chain from state st; frame 0 is intra. Each
        frame's quant is the CRF quant, or quants (I, P) (GOP-granular
        ABR), or, with `law` (ops/rc.py make_abr_law), comes from the
        rate state st.rc, which the frame's exact packed size then
        updates; forced_i says the I frame is a scene cut. Returns the
        GOP's host output, read in one copy (two on overflow)."""
        n = imgs0.shape[0]
        parts, frame_q, dense = {}, [], []
        p_parts = defaultdict(list)   # per key, the P frames' tensors
        for i in range(n):
            is_p = bool(has_ref[i - 1]) if i else False
            mv_i = ({k: mv[k][i - 1] for k in MV_KEYS} if i else None)
            quant = self.quant if quants is None else quants[1 if i else 0]
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
            dcs = torch.stack(dcs).to(torch.int32)
            if i == 0:
                for c, (qv, ll_n) in enumerate(zip(qvals, self.ll_sizes)):
                    q8, pos, vals, nbig = hzcc.compact_dense_i(qv, ll_n)
                    parts.update({f"i_q8{c}": q8, f"i_pos{c}": pos,
                                  f"i_vals{c}": vals, f"i_nbig{c}": nbig})
                parts.update(i_dc=dcs, i_stable=stable)
            else:
                comp = [hzcc.compact_sparse_p(qv, self.cap_div)
                        for qv in qvals]
                for c, (runs, vals, _cnt, _ovf) in enumerate(comp):
                    p_parts[f"p_runs{c}"].append(runs)
                    p_parts[f"p_vals{c}"].append(vals)
                for key, j in (("p_cnt", 2), ("p_ovf", 3)):
                    p_parts[key].append(torch.stack([r[j] for r in comp]))
                p_parts["p_dc"].append(dcs)
                p_parts["p_stable"].append(stable)
            dense.append(qvals)
            frame_q.append(quant)
        parts.update({k: torch.stack(v) for k, v in p_parts.items()})
        if n > 1:
            for k, dt in (("mode", torch.uint8), ("mvx", torch.int16),
                          ("mvy", torch.int16), ("submask", torch.uint8)):
                parts[f"p_{k}"] = mv[k].reshape(n - 1, -1).to(dt)
        host = fetch(parts)   # one read per GOP
        overflow = any(host[f"i_nbig{c}"] > 0 for c in range(3)) \
            or (n > 1 and bool(host["p_ovf"].any()))
        dense_h = None
        if overflow:
            # a cap overflowed: the GOP's dense planes, still on the
            # device, are packed instead (the JAX package's dense redo
            # computes the same planes)
            STATS["overflow_redos"] += 1
            dense_h = fetch_dense(dense)
        return GopOutput(self, host, None if n == 1 else has_ref, frame_q,
                         dense_h)


@lru_cache(maxsize=8)
def build_gop_encoder(subsamp: int, w: int, h: int, G: int, quality: int,
                      do_scd: bool = True, scd_delta: int = 4,
                      intra_thresh: int = 50, stable_refresh: int = 0,
                      pyramid_levels: int = 0, device: str = "cuda",
                      cap_quality: int | None = None, effort: int = 0):
    """The GOP encoder for one geometry (cached)."""
    return GopEncoder(subsamp, w, h, G, quality, do_scd, scd_delta,
                      intra_thresh, stable_refresh, pyramid_levels, device,
                      cap_quality, effort)


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


def _no_p_arrays(C: int):
    """pack_chunk's P-frame arguments for chunks without P frames."""
    z16 = np.zeros((C, 0, 1), np.uint16)
    return ([z16] * 3, [z16.view(np.int16)] * 3,
            [np.zeros((C, 0), np.int32)] * 3, np.zeros((C, 0, 3), np.int32),
            np.zeros((C, 0), np.uint8), np.zeros((C, 0, 1), np.uint8),
            np.zeros((C, 0, 1), np.int16), np.zeros((C, 0, 1), np.int16),
            np.zeros((C, 0, 1), np.uint8), np.zeros((C, 0, 1), np.uint8))


def _encode_intra(frames, meta: Metadata, cfg: EncoderConfig, dev) -> bytes:
    """gop 0 (the JAX package's build_intra_encoder and its gop-0 branch
    of encode_stream_gops): every frame an intra, non-reference picture
    after its own metadata packet; no HME, no recon, every block stable
    (the zeroed accumulators make every block stable,
    dsv_encoder.c:383-393). Frames go through in chunks: each frame's
    planes are compacted on the device (dense int8 plus the LL's large
    values), the host reads a chunk in one copy and packs it in one
    native call; a chunk whose compaction overflowed is read dense and
    packed picture by picture."""
    w, h, subsamp = meta.width, meta.height, meta.subsamp
    blk_w, blk_h, nbh, nbv = block_geometry(w, h)
    quant = crf_quant(cfg.quality)
    prep = make_prep(subsamp, w, h, 0)
    core = build_encode_core(subsamp, w, h, False)
    tables = coef_geometry(subsamp, w, h, nbh, nbv)[2]
    ll_sizes = [hzcc.ll_size(t) for t in tables]
    stable = torch.ones(nbh * nbv, dtype=torch.uint8, device=dev)
    stable_h = np.ones(nbh * nbv, np.uint8)
    chunk = max(1, min(64, (8 << 20) // max(w * h, 1)))
    meta_pkt = bytes(encode_metadata_packet(meta))
    out = bytearray()
    prev_link = 0
    for f0, rows in _packed_gops(frames, chunk):
        k = rows.shape[0]
        with record_function("gop.upload"):
            packed = torch.from_numpy(rows).to(dev)
        with record_function("gop.intra_core"):
            imgs, _al = prep(fr.split_packed_planes(packed, subsamp, w, h))
            dense, comp, dcs = [], [], []
            for img in imgs[0]:
                qvals, dc, _ = core(img, None, False, quant, stable,
                                    None, None, None, None)
                STATS["core_i"] += 1
                dense.append(qvals)
                comp.append([hzcc.compact_dense_i(qv, ll)
                             for qv, ll in zip(qvals, ll_sizes)])
                dcs.append(torch.stack(dc).to(torch.int32))
            parts = {"dc": torch.stack(dcs),
                     "nbig": torch.stack([torch.stack([p[3] for p in f])
                                          for f in comp])}
            for c in range(3):
                for j, name in enumerate(("q8", "pos", "vals")):
                    parts[f"{name}{c}"] = torch.stack([f[c][j] for f in comp])
            host = fetch(parts)   # one read per chunk
            overflow = bool((host["nbig"] > 0).any())
            if overflow:
                STATS["overflow_redos"] += 1
                dense_h = fetch_dense(dense)
        with record_function("gop.pack"):
            if not overflow:
                pkt, prev_link = bits.pack_chunk(
                    FOURCC, VERSION_MINOR, blk_w, blk_h, nbh, nbv, quant,
                    MAX_QP_BITS, meta_pkt, k, 1, f0, f0 + k, f0 + k, 0, 0,
                    [host[f"q8{c}"] for c in range(3)],
                    [host[f"pos{c}"] for c in range(3)],
                    [host[f"vals{c}"] for c in range(3)], host["dc"],
                    np.ones((k, nbh * nbv), np.uint8), *_no_p_arrays(k),
                    prev_link)
                out.extend(pkt)
                continue
            sizes = [t.n for t in tables]
            for i, row in enumerate(dense_h):
                pic = pack_picture(f0 + i, blk_w, blk_h, stable_h, False,
                                   False, None, quant, split_row(row, sizes),
                                   host["dc"][i], nbh, nbv)
                set_link_offsets(pic, prev_link, len(pic))
                prev_link = len(pic)
                out.extend(meta_pkt)
                out.extend(pic)
    out.extend(encode_eos_packet(prev_link))
    return bytes(out)


def _env_int(name: str, default: int) -> int:
    """An integer from the environment, read at each call."""
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _pipelined(items, dispatch, depth_fn):
    """The JAX package's prefetch pipeline (parallel/gop.py _pipelined):
    keeps depth_fn() items dispatched ahead of the one being consumed,
    depth_fn read at each refill. Yields (item, dispatch(item)) in
    order; dispatch runs when the item enters the pipeline."""
    it = iter(items)
    inflight = []
    done = False
    while True:
        while not done and len(inflight) < max(1, depth_fn()):
            nxt = next(it, None)
            if nxt is None:
                done = True
                break
            inflight.append((nxt, dispatch(nxt)))
        if not inflight:
            return
        yield inflight.pop(0)


class _AbrState:
    """GOP-granular ABR (the JAX package's _AbrState, host arithmetic
    unchanged): each packed GOP adds a point (quality, ln bytes per
    frame), and the next GOP's quality comes from a least-squares slope
    over the last three points toward the target bytes per frame (a
    damped default slope before two points exist), each move bounded."""

    _SLOPE0 = 0.008
    _MAX_STEP = 150
    _DAMP = 0.7

    def __init__(self, cfg: EncoderConfig, meta: Metadata):
        self.cfg, self.meta = cfg, meta
        self.q = max(0, min(cfg.quality, MAX_QUALITY))
        fps = (meta.fps_num << 5) // meta.fps_den or 1
        # 7/8 of nominal, like the reference's over-target hysteresis
        # (dsv_encoder.c:833)
        self.target_bpf = max(1, (((cfg.bitrate << 5) // fps) >> 3)
                              * 7 // 8)
        self.pts: list = []   # (quality, ln mean bytes per frame)

    def _clamp(self, q: int) -> int:
        q = max(self.cfg.min_quality, min(q, self.cfg.max_quality))
        return max(0, min(q, MAX_QUALITY))

    def _next_q(self) -> int:
        lt = math.log(self.target_bpf)
        if not self.pts:
            return self.q
        q1, lb1 = self.pts[-1]
        qs = [p[0] for p in self.pts]
        lbs = [p[1] for p in self.pts]
        n = len(qs)
        slope = self._SLOPE0
        if n >= 2:
            mq = sum(qs) / n
            ml = sum(lbs) / n
            den = sum((a - mq) ** 2 for a in qs)
            if den > 0:
                est = sum((a - mq) * (b - ml)
                          for a, b in zip(qs, lbs)) / den
                if est > 1e-4:   # the physical direction only
                    slope = est
        step = self._DAMP * (lt - lb1) / slope
        step = max(-self._MAX_STEP, min(self._MAX_STEP, step))
        return self._clamp(int(q1 + step))

    def gop_quants(self):
        """The next GOP's (I, P) quants and qualities; the I frame gets
        the min_I_frame_quality floor (dsv_encoder.c:133)."""
        self.q = self._next_q()
        quals = (max(self.q, self.cfg.min_I_frame_quality), self.q)
        return tuple(int(quant_of_quality(q)) for q in quals), quals

    def gop_done(self, quality: int, gop_bytes: int, n_frames: int):
        """Add one packed GOP's size."""
        lb = math.log(max(gop_bytes, 1) / max(n_frames, 1))
        self.pts.append((int(quality), lb))
        del self.pts[:-3]


class _GopRunner:
    """The per-GOP steps every GOP mode shares: upload, motion and the
    verdicts' host read, the recon chain, packing."""

    def __init__(self, enc: GopEncoder, meta: Metadata, dev):
        self.enc, self.dev = enc, dev
        self.meta_pkt = bytes(encode_metadata_packet(meta))

    def motion(self, rows):
        """(images, host average lumas, motion, host has_ref)."""
        with record_function("gop.upload"):
            packed = torch.from_numpy(rows).to(self.dev)
        with record_function("gop.motion"):
            imgs, al, mv, has_ref = self.enc.motion(packed)
            # one host read per GOP: the average lumas and the has_ref
            # verdicts
            parts = [al] if has_ref is None else [al, has_ref.to(al.dtype)]
            hv = torch.cat(parts).cpu().numpy()
            n = rows.shape[0]
            return imgs, hv[:n], mv, hv[n:].astype(bool)

    def chain(self, st, imgs, mv, hr, **kw) -> GopOutput:
        with record_function("gop.recon_chain"):
            st.ref_recon = fr.alloc_image(self.enc.layouts[0],
                                          device=self.dev)
            return self.enc.encode_gop(st, imgs[0], mv, hr, **kw)

    def pack(self, res: GopOutput, g0: int, prev_link: int, n_real=None):
        with record_function("gop.pack"):
            return res.pack(self.meta_pkt, g0, prev_link, n_real)


def _encode_gop_abr(frames, cfg: EncoderConfig, run: _GopRunner,
                    st: EncoderState, rate: _AbrState) -> tuple:
    """GOP-granular ABR (the JAX package's abr_mode "gop", one GOP a
    chunk): (stream bytes without EOS, last picture length).

    Replays the JAX package's schedule, on which the bytes depend: a
    GOP's quality is set when the GOP enters the pipeline, which holds
    one GOP until the model has two points and DSV1_PREFETCH GOPs
    (default 2) after that, so GOP k >= 2 mostly sees the sizes up to
    GOP k-2. A short tail GOP reached before calibration is padded with
    its last frame, as the JAX package pads it, since padded frames count
    in its overflow verdict (once calibrated, the verdict only picks
    between two packers of the same bytes, so the port does not pad).
    Calibration runs on the first GOP that did not overflow: its trial
    pack feeds the model, and the GOP is encoded again at the corrected
    quality from its entry state (stability, counter; the motion is
    reused)."""
    G = cfg.gop
    out = bytearray()
    prev_link = 0
    calibrated = False

    def depth():
        return 1 if len(rate.pts) < 2 else _env_int("DSV1_PREFETCH", 2)

    for gi, ((g0, rows), (quants, quals)) in enumerate(_pipelined(
            _packed_gops(frames, G), lambda _item: rate.gop_quants(),
            depth)):
        n = rows.shape[0]
        if n < G and not calibrated:
            rows = np.concatenate([rows, np.repeat(rows[-1:], G - n, 0)])
        imgs, _al, mv, hr = run.motion(rows)
        entry = (st.stability, st.refresh_ctr)
        res = run.chain(st, imgs, mv, hr, quants=quants)
        if not res.overflow and not calibrated:
            calibrated = True
            STATS["calibration_gop"] = gi
            trial, _ = run.pack(res, g0, prev_link, n)
            rate.gop_done(quals[1], sum(picture_sizes(trial,
                                                      len(run.meta_pkt))), n)
            quants, quals = rate.gop_quants()
            st.stability, st.refresh_ctr = entry
            res = run.chain(st, imgs, mv, hr, quants=quants)
        pkt, prev_link = run.pack(res, g0, prev_link, n)
        out.extend(pkt)
        rate.gop_done(quals[1], sum(picture_sizes(pkt, len(run.meta_pkt))),
                      n)
    return out, prev_link


def encode_stream_gops(frames, meta: Metadata,
                       cfg: EncoderConfig | None = None, device="cuda", *,
                       abr_mode: str = "exact") -> bytes:
    """Encode (y, u, v) uint8 frames (any iterable, read GOP by GOP) into
    a full .dsv stream, GOP by GOP on `device`. CRF (gop 0 included:
    intra only), or ABR: with the reference's per-frame law (abr_mode
    "exact") or GOP-granular (abr_mode "gop", `_encode_gop_abr`).
    Byte-identical to the JAX package's encode_stream_gops for the same
    frames and config, effort 1..3 (the wider level-0 motion search,
    ops/hme.py hme_batch) included. Raises the JAX package's ValueError
    for ABR at gop 0 and for gop > 4096 (the sequential `Encoder` runs
    those)."""
    cfg = cfg or EncoderConfig()
    dev = resolve(device)
    abr = cfg.rc_mode != RATE_CONTROL_CRF
    if abr and cfg.gop == GOP_INTRA:
        raise ValueError("GOP-parallel ABR needs gop > 0; "
                         "use models.encoder.Encoder")
    if cfg.gop != GOP_INTRA and cfg.gop > 4096:
        raise ValueError("GOP too long for the device-resident scan; "
                         "use models.encoder.Encoder")
    if abr_mode not in ("exact", "gop"):
        raise ValueError(f"abr_mode must be 'exact' or 'gop', not "
                         f"{abr_mode!r}")
    if cfg.gop == GOP_INTRA:
        return _encode_intra(frames, meta, cfg, dev)
    w, h, subsamp = meta.width, meta.height, meta.subsamp
    G = cfg.gop
    enc = build_gop_encoder(subsamp, w, h, G, cfg.quality, cfg.do_scd,
                            cfg.scene_change_delta, cfg.intra_pct_thresh,
                            cfg.stable_refresh, cfg.pyramid_levels, str(dev),
                            cfg.max_quality if abr else None, cfg.effort)
    run = _GopRunner(enc, meta, dev)
    # GOPs run in order: the accumulators, counter and rate state carry
    # across them
    st = EncoderState(
        stability=torch.zeros((enc.nbh * enc.nbv, 2), dtype=torch.int32,
                              device=dev),
        refresh_ctr=0, prev_al=0, ref_recon=None,
        rc=rc.init_state(cfg.quality, dev) if abr else None)
    if abr and abr_mode == "gop":
        out, prev_link = _encode_gop_abr(frames, cfg, run, st,
                                         _AbrState(cfg, meta))
        out.extend(encode_eos_packet(prev_link))
        return bytes(out)
    law = rc.make_abr_law(cfg, meta) if abr else None
    out = bytearray()
    prev_link = 0
    for g0, rows in _packed_gops(frames, G):
        imgs, al_h, mv, hr = run.motion(rows)
        forced_i = False
        if abr and cfg.do_scd:
            # the GOP's I frame is a scene cut against the previous frame
            # (the zero-initialised luma before frame 0) and so counts as
            # forced intra for the law (dsv_encoder.c:538-554, 133-141)
            forced_i = abs(int(al_h[0]) - st.prev_al) > cfg.scene_change_delta
            st.prev_al = int(al_h[-1])
        res = run.chain(st, imgs, mv, hr, law=law, forced_i=forced_i)
        pkt, prev_link = run.pack(res, g0, prev_link)
        out.extend(pkt)
    out.extend(encode_eos_packet(prev_link))
    return bytes(out)
