"""GOP-parallel encode, CRF or the reference's per-frame ABR, on one
device (mirror of the single-device paths of dsv1_tpu/parallel/gop.py,
copied from the port's plain path).

A closed GOP's frames depend on each other only through the recon chain
and the stability accumulators (dsv_encoder.c:639-674). GOPs go through
in chunks of C GOPs (`gops_per_chunk`: the JAX package's rule, up to 4
CIF GOPs a chunk; one GOP at 1080p and above or under ABR). Everything
that depends only on the input frames — pyramids, HME over every
P-frame pair of the chunk at once, scene-change and forced-intra
verdicts — runs first (`GopEncoder.motion`). The host reads the
has_ref verdicts (and, under ABR, the average lumas) once per chunk.
The stability accumulators, which depend only on the motion fields and
the verdicts, then run over the chunk's frames in stream order
(`GopEncoder.stab_chain`), so each GOP starts from its exact state with
no redo. Then the recon chain runs frame index by frame index, the
chunk's frames of one type at a time (`GopEncoder.chain_steps`: at most
two core calls per frame index, the P frames and the forced-intra
ones). The chunk's quantized planes are compacted (ops/hzcc.py: each I
frame as dense int8 plus the LL's large values, each P slot as a capped
(run, value) list), read to the host in one copy (`ChunkOutput`) and
packed in one native call (bits.pack_chunk). When a cap overflows, the
host reads that chunk's dense planes and packs it picture by picture:
the same bytes. A short tail is padded to a full chunk by repeating its
last frame, as in the JAX package; padded frames are encoded and
dropped at pack time.

Under per-frame ABR (`_encode_abr_exact`, one GOP at a time) the
reference's law (ops/rc.py) picks each frame's quality from the exact
byte size of the picture before it, which ops/piclen.py computes from
the encode core's tensors (the JAX package's in-scan ABR). The host
reads each frame's quality once (`.item()`).
"""

from functools import lru_cache
from itertools import islice

import numpy as np
import torch
from torch.profiler import record_function

from .. import bits
from ..constants import (FOURCC, GOP_INTRA, MAX_QP_BITS, RATE_CONTROL_CRF,
                         VERSION_MINOR, div_round)
from ..models.bitstream import (encode_eos_packet, encode_metadata_packet,
                                set_link_offsets)
from ..models.metadata import Metadata

from ..device import resolve
from ..models.encoder import (MOTION_KEYS, MV_KEYS, EncoderConfig,
                              _stable_update, auto_pyramid_levels,
                              block_geometry, coef_geometry, crf_quant,
                              make_encode_core_traced, make_prep,
                              pack_picture, pyr_layouts, split_row)
from ..ops import frame as fr, hzcc, piclen, rc
from ..ops.hme import hme_batch
from ..state import EncoderState
from ..utils.blob import fetch
from ..utils.stats import STATS


class ChunkOutput:
    """A chunk's encoder output on the host (C GOPs of n frames), read
    from the device in one copy: the compacted planes (`parts`,
    ops/hzcc.py layouts, each with a leading GOP axis), the per-frame
    quants and, when a compaction cap overflowed, the dense planes.
    `pack` assembles the chunk's packets."""

    def __init__(self, enc, parts: dict, has_ref, quants, dense):
        self.enc, self.parts = enc, parts
        self.quants = np.asarray(quants, np.int32)        # (C, n)
        self.C, self.n = self.quants.shape
        self.has_ref = np.asarray(has_ref, bool).reshape(self.C, self.n - 1)
        self.dense = dense     # (C, n, N) int32, or None
        self.overflow = dense is not None

    def _p_arrays(self):
        """The P frames' fields as pack_chunk takes them, (C, n-1, ...)."""
        h = self.parts
        if self.n == 1:
            return _no_p_arrays(self.C)
        return ([h[f"p_runs{c}"].view(np.uint16) for c in range(3)],
                [h[f"p_vals{c}"] for c in range(3)],
                [h["p_cnt"][..., c] for c in range(3)],
                h["p_dc"], self.has_ref.astype(np.uint8), h["p_mode"],
                h["p_mvx"], h["p_mvy"], h["p_submask"], h["p_stable"])

    def pack(self, meta_pkt: bytes, fnum0: int, prev_link: int,
             n_real: int):
        """(each GOP holding a real frame: its metadata packet and its real
        pictures, as bytes; the new prev_link). fnum0 is the chunk's
        first frame number, n_real its real frames (the rest pad its
        tail)."""
        e, h, n = self.enc, self.parts, self.n
        ngops = -(-n_real // n)
        if not self.overflow:
            return bits.pack_chunk(
                FOURCC, VERSION_MINOR, e.blk_w, e.blk_h, e.nbh, e.nbv,
                self.quants, MAX_QP_BITS, meta_pkt, self.C, n, 0, ngops,
                n_real, fnum0, 1, [h[f"i_q8{c}"] for c in range(3)],
                [h[f"i_pos{c}"] for c in range(3)],
                [h[f"i_vals{c}"] for c in range(3)], h["i_dc"],
                h["i_stable"], *self._p_arrays(), prev_link)
        out = bytearray()
        for g in range(ngops):
            out.extend(meta_pkt)
            for i in range(min(n, n_real - g * n)):
                is_p = bool(self.has_ref[g, i - 1]) if i else False
                mv = ({k: h[f"p_{k}"][g, i - 1] for k in MOTION_KEYS}
                      if is_p else None)
                stable = h["p_stable"][g, i - 1] if i else h["i_stable"][g]
                dc = h["p_dc"][g, i - 1] if i else h["i_dc"][g]
                pic = pack_picture(fnum0 + g * n + i, e.blk_w, e.blk_h,
                                   stable, is_p, True, mv,
                                   int(self.quants[g, i]),
                                   split_row(self.dense[g, i],
                                             e.plane_sizes), dc, e.nbh,
                                   e.nbv)
                set_link_offsets(pic, prev_link, len(pic))
                prev_link = len(pic)
                out.extend(pic)
        return bytes(out), prev_link


class GopEncoder:
    """Closed GOPs on one device, a chunk of C GOPs at a time: `motion()`
    for the input-only work, `stab_chain()` for the stability
    accumulators, `chain_steps()` for the recon chain."""

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
        self.core = make_encode_core_traced(
            subsamp, w, h, self.blk_w, self.blk_h, self.nbh, self.nbv)

    def motion(self, packed, calls: list | None = None):
        """packed: (n, fsz) u8 planar frames of one GOP, or (C, n, fsz) of
        a chunk of C GOPs, on the device. Returns (images per pyramid
        level (C * n, flat), average luma ((n,) or (C, n)), motion dict
        over the C * (n-1) P slots, GOP by GOP, has_ref ((n-1,) or
        (C, n-1)) bool). One `hme_batch` call runs every P slot of the
        chunk; its pairs never join two GOPs (each pair reads only its own
        planes and, for the candidates, its own field of the level
        above). `calls` collects the motion search's arguments (ops/hme.py
        hme_batch)."""
        one = packed.dim() == 2
        chunk = packed[None] if one else packed
        C, n = chunk.shape[:2]
        y, u, v = fr.split_packed_planes(chunk.reshape(C * n, -1),
                                         self.subsamp, self.w, self.h)
        imgs, al = self.prep((y, u, v))
        al = al.reshape(C, n)
        mv = has_ref = None
        if n > 1:
            STATS["hme_calls_wide" if self.effort else "hme_calls"] += 1
            if C == 1:
                src, ref = [a[1:] for a in imgs], [a[:-1] for a in imgs]
            else:
                src, ref = ([a.view(C, n, -1)[:, lo:hi].reshape(
                    C * (n - 1), -1) for a in imgs]
                    for lo, hi in ((1, n), (0, n - 1)))
            mv = hme_batch(src, ref, self.layouts, self.blk_w, self.blk_h,
                           self.nbh, self.nbv, self.subsamp, self.levels,
                           calls, self.effort)
            has_ref = (mv["intra_pct"] <= self.intra_thresh).reshape(C,
                                                                     n - 1)
            if self.do_scd:
                has_ref &= (al[:, 1:] - al[:, :-1]).abs() <= self.scd_delta
        if one:
            return imgs, al[0], mv, None if has_ref is None else has_ref[0]
        return imgs, al, mv, has_ref

    def stab_chain(self, st: EncoderState, mv, has_ref, n_real: int):
        """The stability accumulators over a chunk's frames in stream
        order (encode_stable_blocks, dsv_encoder.c:329-400, and the
        refresh increment): the stable blocks (C, n, nblk) u8 on the
        device, each GOP started from its exact state; advances st to the
        state after the chunk's last real frame (of n_real).

        The chain depends only on the motion fields and the has_ref
        verdicts (host), never on the recon chain, so it runs before it.
        The counter is host arithmetic; a GOP whose I frame finds it at 0
        or at the refresh period starts from zeroed accumulators, so
        those GOPs run batched from zero. A GOP that finds it in between
        carries its predecessor's accumulators (the JAX package encodes
        it from zero first and redoes it, `_StabReplay`); its run starts
        from that state once the GOPs before it have run
        (`STATS["stab_carried"]` counts these GOPs). At gop 1 the chain
        never moves (nor, as in the JAX package, does st)."""
        C, n = has_ref.shape[0], has_ref.shape[1] + 1
        nblk = self.nbh * self.nbv
        dev = st.stability.device
        if self.G == 1:
            return torch.ones((C, 1, nblk), dtype=torch.uint8, device=dev)
        sr = self.stable_refresh
        hr = np.asarray(has_ref, bool)
        entry, ctr = [], st.refresh_ctr
        for g in range(C):
            entry.append(ctr)
            for i in range(n):
                ctr = 0 if ctr >= sr else ctr
                ctr += int(i > 0 and hr[g, i - 1])
        ngops = -(-n_real // n)
        carried = [g < ngops and 0 < c < sr for g, c in enumerate(entry)]
        STATS["stab_carried"] += sum(carried)
        fields = None if mv is None else {k: mv[k].reshape(C, n - 1, -1)
                                          for k in MV_KEYS}
        stable = torch.empty((C, n, nblk), dtype=torch.uint8, device=dev)
        g_last, i_last = divmod(n_real - 1, n)
        state = st.stability if carried[0] else None
        a = 0
        while a < C:
            b = a + 1
            while b < C and not carried[b]:
                b += 1
            stab = torch.zeros((b - a, nblk, 2), dtype=torch.int32,
                               device=dev)
            if state is not None:
                stab[0] = state
            ctrs = entry[a:b]
            for i in range(n):
                isp = [bool(i and hr[g, i - 1]) for g in range(a, b)]
                mv_i = ({k: f[a:b, i - 1] for k, f in fields.items()}
                        if any(isp) else None)
                stab, ctrs, stable[a:b, i] = _stable_update(
                    stab, ctrs, isp, mv_i, sr)
                ctrs = [c + p for c, p in zip(ctrs, isp)]
                if a <= g_last < b and i == i_last:
                    st.stability = stab[g_last - a].clone()
                    st.refresh_ctr = ctrs[g_last - a]
            state = stab[-1]
            a = b
        return stable

    def chain_steps(self, st: EncoderState, imgs0, mv, has_ref, stable,
                    quants=None, law=None, forced_i: bool = False):
        """The recon chain of a chunk of C GOPs of n frames: imgs0 the
        level-0 images (C * n, flat), has_ref (C, n-1) host, stable the
        stable blocks (`stab_chain`). Frame index by frame index, the
        GOPs' frames of each type go through the core together (at most
        two core calls: the P frames, and the I frames of the GOPs whose
        slot lost its reference), each from its own GOP's reference.
        Each frame's quant is the CRF quant, or quants (I, P) (GOP-
        granular ABR), or, with `law` (ops/rc.py make_abr_law; C = 1),
        comes from the rate state st.rc, which the frame's exact packed
        size then updates; forced_i says the I frame is a scene cut.
        Compacts the chunk's planes and returns its host output, the
        ChunkOutput, read in one copy (two on overflow)."""
        C, n = stable.shape[:2]
        dev = stable.device
        hr = np.asarray(has_ref, bool).reshape(C, n - 1)
        im = imgs0.view(C, n, -1)
        fields = None if n == 1 else {k: mv[k].reshape(C, n - 1, -1)
                                      for k in MOTION_KEYS}
        qbuf = [torch.empty((C, n, t), dtype=torch.int32, device=dev)
                for t in self.plane_sizes]
        dcs = torch.empty((C, n, 3), dtype=torch.int32, device=dev)
        frame_q = np.empty((C, n), np.int32)
        ref = None
        for i in range(n):
            isp = hr[:, i - 1] if i else np.zeros(C, bool)
            quant = self.quant if quants is None else quants[1 if i else 0]
            if law is not None:
                # a P slot that lost has_ref is a forced-intra frame
                # (SCD / intra % promotion): the law boosts its quality
                # (dsv_encoder.c:133-141)
                is_p = bool(isp[0])
                with record_function("gop.rate_read"):
                    q, st.rc = law[0](st.rc, is_p, forced_i if i == 0
                                      else not is_p)
                    quality = int(q.item())   # the one host read per frame
                quant = crf_quant(quality)
            new_ref = None
            for sub_p in (True, False):
                sel = np.flatnonzero(isp == sub_p)
                if sel.size == 0:
                    continue
                if sel.size == C:
                    def take(t):
                        return t
                else:
                    idx = torch.from_numpy(sel).to(dev, non_blocking=True)

                    def take(t):
                        return t.index_select(0, idx)
                margs = (tuple(take(fields[k][:, i - 1])
                               for k in MOTION_KEYS) if sub_p
                         else (None,) * 4)
                qv, dc, recon = self.core(take(im[:, i]),
                                          take(ref) if sub_p else None,
                                          sub_p, quant, take(stable[:, i]),
                                          *margs)
                dc = torch.stack(dc, -1).to(torch.int32)
                if sel.size == C:
                    for c in range(3):
                        qbuf[c][:, i] = qv[c]
                    dcs[:, i] = dc
                    new_ref = recon
                    continue
                for c in range(3):
                    qbuf[c][:, i].index_copy_(0, idx,
                                              qv[c].to(torch.int32))
                dcs[:, i].index_copy_(0, idx, dc)
                if new_ref is None:
                    new_ref = recon.new_empty((C, recon.shape[-1]))
                new_ref.index_copy_(0, idx, recon)
            if law is not None:
                plen = piclen.picture_len(
                    self.blk_w, self.blk_h, self.nbh, self.nbv, MAX_QP_BITS,
                    stable[0, i], is_p, *(fields[k][0, i - 1] if is_p
                                          else None for k in MOTION_KEYS),
                    [q[0, i] for q in qbuf], dcs[0, i])
                st.rc = law[1](st.rc, is_p, quality, plen)
            ref = new_ref
            frame_q[:, i] = quant
        parts = {"i_dc": dcs[:, 0], "i_stable": stable[:, 0]}
        for c, (qv, ll_n) in enumerate(zip(qbuf, self.ll_sizes)):
            q8, pos, vals, nbig = hzcc.compact_dense_i(qv[:, 0], ll_n)
            parts.update({f"i_q8{c}": q8, f"i_pos{c}": pos,
                          f"i_vals{c}": vals, f"i_nbig{c}": nbig})
        if n > 1:
            comp = [hzcc.compact_sparse_p(qv[:, 1:], self.cap_div)
                    for qv in qbuf]
            for c, (runs, vals, _cnt, _ovf) in enumerate(comp):
                parts.update({f"p_runs{c}": runs, f"p_vals{c}": vals})
            parts["p_cnt"] = torch.stack([r[2] for r in comp], -1)
            parts["p_ovf"] = torch.stack([r[3] for r in comp], -1)
            parts.update(p_dc=dcs[:, 1:], p_stable=stable[:, 1:])
            for k, dt in (("mode", torch.uint8), ("mvx", torch.int16),
                          ("mvy", torch.int16), ("submask", torch.uint8)):
                parts[f"p_{k}"] = fields[k].to(dt)
        host = fetch(parts)   # one read per chunk
        overflow = any(host[f"i_nbig{c}"].any() for c in range(3)) \
            or (n > 1 and bool(host["p_ovf"].any()))
        dense_h = None
        if overflow:
            # a cap overflowed: the chunk's dense planes are packed
            # instead (the JAX package's dense redo
            # computes the same planes)
            STATS["overflow_redos"] += 1
            dense_h = fetch({"dense": torch.cat(qbuf, -1)})["dense"]
        return ChunkOutput(self, host, hr, frame_q, dense_h)


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


def _chunks(frames, C: int, G: int, pad: bool = True):
    """(first frame number, (C, G, fsz) u8 raw planar rows, real frames)
    per chunk of C GOPs of G frames, read from any iterable as they
    come. A short tail is padded by repeating its last real frame (the
    JAX package's _ChunkReader); with pad False (C = 1) a short tail
    comes as (1, n, fsz)."""
    it = iter(frames)
    f0 = 0
    while True:
        rows = [fr.np_pack_planes(f) for f in islice(it, C * G)]
        if not rows:
            return
        k = len(rows)
        if pad:
            rows += [rows[-1]] * (C * G - k)
        yield f0, np.stack(rows).reshape(C if pad else 1, -1,
                                         rows[0].size), k
        f0 += k


def _no_p_arrays(C: int):
    """pack_chunk's P-frame arguments for chunks without P frames."""
    z16 = np.zeros((C, 0, 1), np.uint16)
    return ([z16] * 3, [z16.view(np.int16)] * 3,
            [np.zeros((C, 0), np.int32)] * 3, np.zeros((C, 0, 3), np.int32),
            np.zeros((C, 0), np.uint8), np.zeros((C, 0, 1), np.uint8),
            np.zeros((C, 0, 1), np.int16), np.zeros((C, 0, 1), np.int16),
            np.zeros((C, 0, 1), np.uint8), np.zeros((C, 0, 1), np.uint8))


class _GopRunner:
    """The per-chunk steps both modes share (upload, motion and the
    verdicts' host read, the stability chain, the recon chain, packing)
    for one GOP encoder."""

    def __init__(self, enc: GopEncoder, meta: Metadata):
        self.enc = enc
        self.meta_pkt = bytes(encode_metadata_packet(meta))

    def motion(self, rows):
        """rows (C, n, fsz) -> (images and motion, host average lumas
        (C, n), host has_ref (C, n-1))."""
        C, n = rows.shape[:2]
        with record_function("gop.upload"):
            packed = torch.from_numpy(rows).to(self.enc.device)
        with record_function("gop.motion"):
            imgs, al, mv, has_ref = self.enc.motion(packed)
            parts = [al.reshape(-1)]
            if has_ref is not None:
                parts.append(has_ref.reshape(-1).to(al.dtype))
            # one host read per chunk: the average lumas and the has_ref
            # verdicts
            hv = torch.cat(parts).cpu().numpy()
            return ((imgs, mv), hv[:C * n].reshape(C, n),
                    hv[C * n:].astype(bool).reshape(C, n - 1))

    def stability(self, st, mot, hr, n_real: int):
        """The stable blocks (C, n, nblk) from the chunk's stability
        chain."""
        with record_function("gop.stability"):
            return self.enc.stab_chain(st, mot[1], hr, n_real)

    def chain(self, st, mot, hr, stable, **kw):
        """The recon chain: its ChunkOutput."""
        with record_function("gop.recon_chain"):
            return self.enc.chain_steps(st, mot[0][0], mot[1], hr, stable,
                                        **kw)

    def pack(self, res: ChunkOutput, fnum0: int, prev_link: int,
             n_real: int):
        """The chunk's GOPs holding a real frame, packed in GOP order."""
        with record_function("gop.pack"):
            return res.pack(self.meta_pkt, fnum0, prev_link, n_real)


def _encode_chunks(frames, G: int, C: int, run: _GopRunner,
                   st: EncoderState) -> tuple:
    """CRF, C GOPs a chunk: (stream bytes without EOS, last picture
    length)."""
    out = bytearray()
    prev_link = 0
    for f0, rows, n_real in _chunks(frames, C, G):
        STATS["chunks"] += 1
        mot, _al, hr = run.motion(rows)
        stable = run.stability(st, mot, hr, n_real)
        res = run.chain(st, mot, hr, stable)
        pkt, prev_link = run.pack(res, f0, prev_link, n_real)
        out.extend(pkt)
    return out, prev_link


def _encode_abr_exact(frames, cfg: EncoderConfig, meta: Metadata,
                      run: _GopRunner, st: EncoderState) -> tuple:
    """The reference's per-frame ABR law, one GOP at a time (the JAX
    package's chunk is a serial scan over its GOPs, so its bytes do not
    depend on the chunk): (stream bytes without EOS, last picture
    length)."""
    law = rc.make_abr_law(cfg, meta)
    out = bytearray()
    prev_link = 0
    for f0, rows, n_real in _chunks(frames, 1, cfg.gop, pad=False):
        STATS["chunks"] += 1
        mot, al_h, hr = run.motion(rows)
        forced_i = False
        if cfg.do_scd:
            # the GOP's I frame is a scene cut against the previous frame
            # (the zero-initialised luma before frame 0) and so counts as
            # forced intra for the law (dsv_encoder.c:538-554, 133-141)
            forced_i = abs(int(al_h[0, 0]) - st.prev_al) \
                > cfg.scene_change_delta
            st.prev_al = int(al_h[0, -1])
        stable = run.stability(st, mot, hr, n_real)
        res = run.chain(st, mot, hr, stable, law=law, forced_i=forced_i)
        pkt, prev_link = run.pack(res, f0, prev_link, n_real)
        out.extend(pkt)
    return out, prev_link


def gops_per_chunk(w: int, h: int, G: int, n_frames: int = 0) -> int:
    """GOPs a CRF chunk, the JAX package's rule: as many GOPs as fit the
    pixels of 4 CIF GOPs of 12 frames, at most 4 and at most the GOPs of
    the input where its length is known."""
    known = div_round(n_frames, G) if n_frames else 0
    return max(1, min(4, (4 * 352 * 288 * 12) // max(G * w * h, 1),
                      known or (1 << 30)))


def encode_stream_gops(frames, meta: Metadata,
                       cfg: EncoderConfig | None = None, device="cuda"):
    """Encode (y, u, v) uint8 frames (any iterable, read chunk by chunk)
    into a full .dsv stream on `device`: CRF, or ABR with the reference's
    per-frame law. Byte-identical to the JAX package's encode_stream_gops
    for the same frames and config on one device (its default chunk and
    abr_mode "exact"), effort 1..3 (the wider level-0 motion search,
    ops/hme.py hme_batch) included. Raises ValueError for gop 0 and
    gop > 4096, which the reference copy does not encode."""
    cfg = cfg or EncoderConfig()
    dev = resolve(device)
    if cfg.gop == GOP_INTRA or cfg.gop > 4096:
        raise ValueError("the reference encodes GOPs of 1 to 4096 frames")
    abr = cfg.rc_mode != RATE_CONTROL_CRF
    w, h, subsamp = meta.width, meta.height, meta.subsamp
    G = cfg.gop
    enc = build_gop_encoder(subsamp, w, h, G, cfg.quality, cfg.do_scd,
                            cfg.scene_change_delta, cfg.intra_pct_thresh,
                            cfg.stable_refresh, cfg.pyramid_levels, str(dev),
                            cfg.max_quality if abr else None, cfg.effort)
    nblk = enc.nbh * enc.nbv
    st = EncoderState(
        stability=torch.zeros((nblk, 2), dtype=torch.int32, device=dev),
        refresh_ctr=0, prev_al=0, ref_recon=None,
        rc=rc.init_state(cfg.quality, dev) if abr else None)
    run = _GopRunner(enc, meta)
    if abr:
        out, prev_link = _encode_abr_exact(frames, cfg, meta, run, st)
    else:
        C = gops_per_chunk(w, h, G, len(frames) if hasattr(
            frames, "__len__") else 0)
        out, prev_link = _encode_chunks(frames, G, C, run, st)
    out.extend(encode_eos_packet(prev_link))
    return bytes(out)
