"""GOP-parallel encode, CRF, per-frame ABR or GOP-granular ABR (mirror of
the single-device paths of dsv1_tpu/parallel/gop.py).

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
chunk's frames of one type at a time through one launch of each kernel
(`GopEncoder.chain_steps`: at most two core calls per frame index, the
P frames and the forced-intra ones). The chunk's quantized planes are
compacted on the device (ops/hzcc.py: each I frame as dense int8 plus
the LL's large values, each P slot as a capped (run, value) list), and
the host reads the chunk's compacted planes, DCs, stable blocks and
motion fields in one copy (`ChunkOutput`) and packs the whole chunk in
one native call (bits.pack_chunk). When a cap overflows, the device
lists every symbol of that chunk's planes, uncapped (hzcc.compact_exact),
and the host reads the lists and packs the chunk picture by picture:
the same bytes (`STATS["overflow_redos"]` counts these chunks). A short
tail is padded to a full chunk by repeating its last frame, as in the
JAX package; padded frames are encoded and dropped at pack time. Frames
are read chunk by chunk: a long or large input is never held whole. At
gop 0 (intra only) every frame is its own GOP with no HME and no recon,
and frames go through in chunks (`_encode_intra`), an overflowed chunk
through the same exact compaction.

Over a mesh (`mesh=`: a GOP mesh, or a gop x tile mesh, parallel/mesh.py)
a chunk is C GOPs for each row of the mesh (a 'gop' index), split
contiguously as the JAX package's `PartitionSpec("gop")` splits them
(`_GopRunner`): each row's GOPs get their upload, motion, recon chain,
compaction and host read on the row's first device, the stability chain
runs over the whole chunk in stream order (so a state carried into a GOP
crosses a row boundary), and the rows' work is queued step by step, one
row after the other (`_drive`), so distinct devices overlap. A gop x
tile row runs its encode core's subband transforms in column tiles over
its devices (parallel/tile.py). The bytes are those of one device at
that chunk.

Under per-frame ABR (`_encode_abr_exact`, one GOP at a time) the
reference's law (ops/rc.py) picks each frame's quality from the exact
byte size of the picture before it, which ops/piclen.py computes on the
device from the encode core's tensors (the JAX package's in-scan ABR).
The core keeps its quant-derived scalars as host ints, so the host
reads each frame's quality once (`.item()`): one device sync per frame.

With abr_mode "gop" (`_encode_chunks` with a rate model) each chunk has
one quality, which a host model of the rate-quality curve (`_AbrState`)
sets from the sizes of the GOPs packed before it. The JAX package
pipelines its chunks, so a chunk's quality is set when the chunk is
dispatched, before the chunks ahead of it are packed; the port replays
that schedule on the host (`_pipelined`), and so gives the same bytes.
The first chunk whose compacted planes fit their caps is packed as a
trial, the model corrected, and the chunk encoded again from the state
it started from.

Each chunk's phases run under `torch.profiler.record_function` spans
(`gop.upload`, `gop.motion`, `gop.stability`, `gop.recon_chain`,
`gop.pack`); each span ends on a host read or a host-only step, so its
host time covers its device work (`gop.stability` queues device work
that `gop.recon_chain`'s read waits for). Inside the recon chain,
`gop.rate_read` spans each per-frame ABR frame's law and quality read:
its host time is the per-frame sync, mostly the wait for the previous
frame's device work. `encode.read` spans each blocking read of a chunk
(inside `gop.motion` and `gop.recon_chain`), `encode.intake` the
reading and stacking of each chunk's input frames (`_chunks`), and
`encode.finish` a request's end (the state read, the EOS, the stream's
copy). At gop 0 `gop.intra_core` and `gop.intra_compact` name the core
and the compactions, the capped one and on overflow the exact one
(`_encode_intra`). tools/torch_profile.py and the benchmark's readers
read them.
"""

import math
import os
from functools import lru_cache
from itertools import islice

import numpy as np
import torch
from torch.profiler import record_function

from .. import bits
from ..constants import (FOURCC, GOP_INTRA, MAX_QP_BITS, MAX_QUALITY,
                         RATE_CONTROL_CRF, VERSION_MINOR, div_round,
                         quant_of_quality)
from ..models.bitstream import (encode_eos_packet, encode_metadata_packet,
                                set_link_offsets)
from ..models.metadata import Metadata

from ..device import resolve
from ..models.encoder import (MOTION_KEYS, MV_KEYS, EncoderConfig,
                              _stable_update, auto_pyramid_levels,
                              block_geometry, build_encode_core,
                              coef_geometry, crf_quant,
                              make_encode_core_traced, make_prep,
                              pack_picture, pyr_layouts)
from ..ops import frame as fr, hzcc, piclen, rc
from ..ops.hme import hme_batch
from ..state import EncoderState
from ..utils.blob import fetch, to_host
from ..utils.stats import STATS
from .mesh import Mesh, gop_rows
from .tile import tile_hook


class ChunkOutput:
    """A chunk's encoder output on the host (C GOPs of n frames), read
    from the device in one copy: the compacted planes (`parts`,
    ops/hzcc.py layouts, each with a leading GOP axis), the per-frame
    quants and, when a compaction cap overflowed, every plane's (run,
    value) lists (`hzcc.exact_lists`, [plane][GOP * n + frame]). `pack`
    assembles the chunk's packets."""

    def __init__(self, enc, parts: dict, has_ref, quants, lists):
        self.enc, self.parts = enc, parts
        self.quants = np.asarray(quants, np.int32)        # (C, n)
        self.C, self.n = self.quants.shape
        self.has_ref = np.asarray(has_ref, bool).reshape(self.C, self.n - 1)
        self.lists = lists
        self.overflow = lists is not None

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
                                   [p[g * n + i] for p in self.lists], dc,
                                   e.nbh, e.nbv)
                set_link_offsets(pic, prev_link, len(pic))
                prev_link = len(pic)
                out.extend(pic)
        return bytes(out), prev_link


def gop_bytes(pkt: bytes, meta_len: int, n_real: int, G: int) -> list:
    """(bytes, frames) of each GOP of a packed chunk (each GOP's metadata
    packet first, then its pictures), from each picture's next-link
    field at byte 10."""
    out, off = [], 0
    for g in range(-(-n_real // G)):
        off += meta_len
        nf, acc = min(G, n_real - g * G), 0
        for _ in range(nf):
            plen = int.from_bytes(pkt[off + 10:off + 14], "big")
            acc += plen
            off += plen
        out.append((acc, nf))
    return out


class GopEncoder:
    """Closed GOPs on one device, a chunk of C GOPs at a time: `motion()`
    for the input-only work, `stab_chain()` for the stability
    accumulators, `chain_steps()` for the recon chain. With `tiles` (a
    gop x tile mesh row's devices, the first of them `device`) the
    encode core's subband transforms run in column tiles over them
    (parallel/tile.py)."""

    def __init__(self, subsamp: int, w: int, h: int, G: int, quality: int,
                 do_scd: bool = True, scd_delta: int = 4,
                 intra_thresh: int = 50, stable_refresh: int = 0,
                 pyramid_levels: int = 0, device="cuda",
                 cap_quality: int | None = None, effort: int = 0,
                 tiles: tuple = ()):
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
            subsamp, w, h, self.blk_w, self.blk_h, self.nbh, self.nbv,
            tile_hook=tile_hook([resolve(d) for d in tiles]) if tiles
            else None)

    def motion(self, packed, calls: list | None = None):
        """packed: (n, fsz) u8 planar frames of one GOP, or (C, n, fsz) of
        a chunk of C GOPs, on the device. Returns (images per pyramid
        level (C * n, flat), average luma ((n,) or (C, n)), motion dict
        over the C * (n-1) P slots, GOP by GOP, has_ref ((n-1,) or
        (C, n-1)) bool). One `hme_batch` call runs every P slot of the
        chunk; its pairs never join two GOPs (each kernel reads only its
        own pair's planes and, for the candidates, its own pair's field
        of the level above, csrc/hme.cu parent_cand). `calls` collects
        the HME kernels' arguments (ops/hme.py hme_batch)."""
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
        Compacts the chunk's planes on the device and returns its host
        output, read in one copy (two on overflow). A generator: it
        yields after each frame index's work is queued and after the
        compaction is queued, and returns the ChunkOutput (`_drive` runs
        several, one per device, in step)."""
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
                    STATS["host_reads"] += 1
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
            yield
        # the I planes' nonzero counts size the exact compaction's lists
        # where a cap overflows (the P planes' are the sparse compaction's)
        parts = {"i_dc": dcs[:, 0], "i_stable": stable[:, 0],
                 "i_cnt": torch.stack([(qv[:, 0] != 0).sum(
                     -1, dtype=torch.int32) for qv in qbuf], -1)}
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
        yield
        with record_function("encode.read"):
            host = fetch(parts)   # one read per chunk
        ovf_i = any(host[f"i_nbig{c}"].any() for c in range(3))
        ovf_p = n > 1 and bool(host["p_ovf"].any())
        STATS["overflow_i"] += ovf_i
        STATS["overflow_p"] += ovf_p
        lists = None
        if ovf_i or ovf_p:
            # a cap overflowed: every symbol of the chunk's planes, still
            # on the device, is listed exactly at offsets from the counts
            # read above, and packed instead (the JAX package's dense redo
            # computes the same planes)
            STATS["overflow_redos"] += 1
            cnt = host["i_cnt"].T[:, :, None]
            if n > 1:
                cnt = np.concatenate([cnt, host["p_cnt"].transpose(2, 0, 1)],
                                     -1)
            cnt = cnt.reshape(3, C * n)
            total = int(cnt.sum())
            STATS["overflow_exact"] += 1
            STATS["overflow_syms"] += total
            buf = hzcc.compact_exact(qbuf, total)
            with record_function("encode.read"):
                lists = hzcc.exact_lists(fetch({"syms": buf})["syms"], cnt)
        return ChunkOutput(self, host, hr, frame_q, lists)


def _drive(gens) -> list:
    """Runs generators in step, one step of each in turn, to their ends;
    returns their return values. Each yields after queueing a step's
    device work, so the work of generators on distinct devices
    overlaps."""
    out = [None] * len(gens)
    live = list(range(len(gens)))
    while live:
        for j in list(live):
            try:
                next(gens[j])
            except StopIteration as e:
                out[j] = e.value
                live.remove(j)
    return out


@lru_cache(maxsize=8)
def build_gop_encoder(subsamp: int, w: int, h: int, G: int, quality: int,
                      do_scd: bool = True, scd_delta: int = 4,
                      intra_thresh: int = 50, stable_refresh: int = 0,
                      pyramid_levels: int = 0, device: str = "cuda",
                      cap_quality: int | None = None, effort: int = 0,
                      tiles: tuple = ()):
    """The GOP encoder for one geometry (cached)."""
    return GopEncoder(subsamp, w, h, G, quality, do_scd, scd_delta,
                      intra_thresh, stable_refresh, pyramid_levels, device,
                      cap_quality, effort, tiles)


def _chunks(frames, C: int, G: int, pad: bool = True):
    """(first frame number, (C, G, fsz) u8 raw planar rows, real frames)
    per chunk of C GOPs of G frames, read from any iterable as they
    come. A short tail is padded by repeating its last real frame (the
    JAX package's _ChunkReader); with pad False (C = 1) a short tail
    comes as (1, n, fsz). Each chunk's pulls from `frames`, packing and
    stacking run under an `encode.intake` span (one more for the pull
    that finds the input's end), closed before the chunk is handed on."""
    it = iter(frames)
    f0 = 0
    while True:
        with record_function("encode.intake"):
            rows = [fr.np_pack_planes(f) for f in islice(it, C * G)]
            k = len(rows)
            if k:
                if pad:
                    rows += [rows[-1]] * (C * G - k)
                chunk = np.stack(rows).reshape(C if pad else 1, -1,
                                               rows[0].size)
        if not k:
            return
        yield f0, chunk, k
        f0 += k


def _no_p_arrays(C: int):
    """pack_chunk's P-frame arguments for chunks without P frames."""
    z16 = np.zeros((C, 0, 1), np.uint16)
    return ([z16] * 3, [z16.view(np.int16)] * 3,
            [np.zeros((C, 0), np.int32)] * 3, np.zeros((C, 0, 3), np.int32),
            np.zeros((C, 0), np.uint8), np.zeros((C, 0, 1), np.uint8),
            np.zeros((C, 0, 1), np.int16), np.zeros((C, 0, 1), np.int16),
            np.zeros((C, 0, 1), np.uint8), np.zeros((C, 0, 1), np.uint8))


def _intra_parts(dense, dcs, ll_sizes) -> dict:
    """The compacted planes of a gop-0 chunk's frames (`dense`: per frame
    its three quantized planes; `dcs`: per frame its (3,) int32 DCs) as
    `fetch` reads them: each plane's `compact_dense_i` stacked over the
    frames, the DCs, the overflow counts `nbig` (frames, 3) and the
    nonzero counts `cnt` (frames, 3), which size the exact compaction's
    lists where a cap overflows."""
    comp = [[hzcc.compact_dense_i(qv, ll) for qv, ll in zip(qvals, ll_sizes)]
            for qvals in dense]
    parts = {"dc": torch.stack(dcs),
             "nbig": torch.stack([torch.stack([p[3] for p in f])
                                  for f in comp]),
             "cnt": torch.stack([torch.stack([(qv != 0).sum(
                 dtype=torch.int32) for qv in qvals]) for qvals in dense])}
    for c in range(3):
        for j, name in enumerate(("q8", "pos", "vals")):
            parts[f"{name}{c}"] = torch.stack([f[c][j] for f in comp])
    return parts


def _encode_intra(frames, meta: Metadata, cfg: EncoderConfig, dev,
                  fnum_base: int = 0):
    """gop 0 (the JAX package's build_intra_encoder and its gop-0 branch
    of encode_stream_gops): every frame an intra, non-reference picture
    after its own metadata packet; no HME, no recon, every block stable
    (the zeroed accumulators make every block stable,
    dsv_encoder.c:383-393). Frames go through in chunks: each frame's
    planes are compacted on the device (dense int8 plus the LL's large
    values), the host reads a chunk in one copy and packs it in one
    native call; where the compaction overflowed, the device lists every
    symbol of the chunk's planes exactly (hzcc.compact_exact, at offsets
    from the nonzero counts of the first read), the host reads the
    (run, value) lists and packs them picture by picture: the same bytes.
    Spans: `gop.upload`, `gop.intra_core` (the prep and the frames' core
    calls), `gop.intra_compact` (the compaction's launches, and the exact
    compaction's on overflow), `encode.read` (the compacted read and the
    lists' read), `gop.pack`. Frame numbers start at fnum_base.
    Returns (the stream without EOS, the last picture's length)."""
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
    for f0, rows, k in _chunks(frames, 1, chunk, pad=False):
        rows = rows[0]
        STATS["intra_chunks"] += 1
        with record_function("gop.upload"):
            packed = torch.from_numpy(rows).to(dev)
        with record_function("gop.intra_core"):
            imgs, _al = prep(fr.split_packed_planes(packed, subsamp, w, h))
            dense, dcs = [], []
            for img in imgs[0]:
                qvals, dc, _ = core(img, None, False, quant, stable,
                                    None, None, None, None)
                dense.append(qvals)
                dcs.append(torch.stack(dc).to(torch.int32))
        with record_function("gop.intra_compact"):
            parts = _intra_parts(dense, dcs, ll_sizes)
        with record_function("encode.read"):
            host = fetch(parts)   # one read per chunk
        overflow = bool((host["nbig"] > 0).any())
        STATS["overflow_i"] += overflow
        if overflow:
            # the I cap overflowed: every symbol of the chunk's planes,
            # still on the device, is listed exactly at offsets from the
            # counts read above, and packed instead (the JAX package reads
            # the same planes dense)
            STATS["overflow_redos"] += 1
            cnt = host["cnt"].T
            total = int(cnt.sum())
            STATS["overflow_exact"] += 1
            STATS["overflow_syms"] += total
            with record_function("gop.intra_compact"):
                buf = hzcc.compact_exact(
                    [torch.stack([qvals[c] for qvals in dense])
                     .to(torch.int32) for c in range(3)], total)
            with record_function("encode.read"):
                lists = hzcc.exact_lists(fetch({"syms": buf})["syms"], cnt)
        with record_function("gop.pack"):
            if not overflow:
                pkt, prev_link = bits.pack_chunk(
                    FOURCC, VERSION_MINOR, blk_w, blk_h, nbh, nbv, quant,
                    MAX_QP_BITS, meta_pkt, k, 1, f0, f0 + k, f0 + k,
                    fnum_base, 0,
                    [host[f"q8{c}"] for c in range(3)],
                    [host[f"pos{c}"] for c in range(3)],
                    [host[f"vals{c}"] for c in range(3)], host["dc"],
                    np.ones((k, nbh * nbv), np.uint8), *_no_p_arrays(k),
                    prev_link)
                out.extend(pkt)
                continue
            for i in range(k):
                pic = pack_picture(fnum_base + f0 + i, blk_w, blk_h,
                                   stable_h, False, False, None, quant,
                                   [lists[c][i] for c in range(3)],
                                   host["dc"][i], nbh, nbv)
                set_link_offsets(pic, prev_link, len(pic))
                prev_link = len(pic)
                out.extend(meta_pkt)
                out.extend(pic)
    return out, prev_link


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
    """The per-chunk steps every GOP mode shares (upload, motion and the
    verdicts' host read, the stability chain, the recon chain, packing)
    over the GOP rows of a mesh: one encoder per row (one row without a
    mesh), each row taking `per` GOPs of a chunk, a contiguous split as
    `PartitionSpec("gop")` lays them out. Each row's GOPs get their
    upload, motion, recon chain, compaction and read on its device; the
    stability chain runs over the whole chunk in stream order on the
    first row's device, so a carried state crosses a row boundary. The
    rows' work is queued in turn, step by step, so distinct devices
    overlap."""

    def __init__(self, encs: list, meta: Metadata, per: int):
        self.encs, self.per = encs, per
        self.meta_pkt = bytes(encode_metadata_packet(meta))

    def _rows(self, a):
        return [a[r * self.per:(r + 1) * self.per]
                for r in range(len(self.encs))]

    def motion(self, rows):
        """rows (C, n, fsz) -> (per row its images and motion, host
        average lumas (C, n), host has_ref (C, n-1))."""
        C, n = rows.shape[:2]
        with record_function("gop.upload"):
            packed = [torch.from_numpy(r).to(e.device)
                      for e, r in zip(self.encs, self._rows(rows))]
        with record_function("gop.motion"):
            outs = []
            for e, pk in zip(self.encs, packed):
                imgs, al, mv, has_ref = e.motion(pk)
                parts = [al.reshape(-1)]
                if has_ref is not None:
                    parts.append(has_ref.reshape(-1).to(al.dtype))
                outs.append((imgs, mv, torch.cat(parts)))
            # one host read per row and chunk: the average lumas and the
            # has_ref verdicts
            with record_function("encode.read"):
                hv = [to_host(o[2]) for o in outs]
            k = self.per * n
            return ([(o[0], o[1]) for o in outs],
                    np.concatenate([h[:k] for h in hv]).reshape(C, n),
                    np.concatenate([h[k:] for h in hv]).astype(bool)
                    .reshape(C, n - 1))

    def stability(self, st, mots, hr, n_real: int):
        """The stable blocks of every row, (per, n, nblk) each on its
        row's device, from the whole chunk's stability chain."""
        with record_function("gop.stability"):
            e0 = self.encs[0]
            mvs = [m for _i, m in mots]
            mv = (None if mvs[0] is None else
                  mvs[0] if len(mvs) == 1 else
                  {k: torch.cat([m[k].to(st.stability.device) for m in mvs])
                   for k in MV_KEYS})
            stable = e0.stab_chain(st, mv, hr, n_real)
            return [t.to(e.device) for e, t in zip(self.encs,
                                                   self._rows(stable))]

    def chain(self, st, mots, hr, stables, **kw) -> list:
        """The rows' recon chains, queued in step: their ChunkOutputs."""
        with record_function("gop.recon_chain"):
            return _drive([e.chain_steps(st, imgs[0], mv, h, stb, **kw)
                           for e, (imgs, mv), h, stb in zip(
                               self.encs, mots, self._rows(hr), stables)])

    def pack(self, res: list, fnum0: int, prev_link: int, n_real: int):
        """Each row's GOPs holding a real frame, packed in GOP order."""
        with record_function("gop.pack"):
            out = bytearray()
            span = self.per * res[0].n
            for r, ro in enumerate(res):
                k = min(max(n_real - r * span, 0), span)
                if k:
                    pkt, prev_link = ro.pack(self.meta_pkt, fnum0 + r * span,
                                             prev_link, k)
                    out.extend(pkt)
            return bytes(out), prev_link


def _encode_chunks(frames, G: int, C: int, run: _GopRunner,
                   st: EncoderState, fnum_base: int,
                   rate: _AbrState | None = None) -> tuple:
    """CRF, or GOP-granular ABR with `rate` (the JAX package's abr_mode
    "gop"), C GOPs a chunk: (stream bytes without EOS, last picture
    length).

    Under GOP-granular ABR a chunk's GOPs share one quality, and the
    port replays the JAX package's schedule, on which the bytes depend:
    a chunk's quality is set when the chunk enters the pipeline, which
    holds one chunk until the model has two points and DSV1_PREFETCH
    chunks (default 2) after that, so chunk k >= 2 mostly sees the sizes
    up to chunk k-2. Each real GOP of a packed chunk adds a point. The
    first chunk whose compacted planes fit their caps (padded GOPs and
    frames count in that verdict, as in the JAX package) is packed as a
    trial, the model fed and the chunk encoded again at the corrected
    quality from its entry state (the motion and the stability chain are
    reused)."""
    out = bytearray()
    prev_link = 0
    calibrated = rate is None
    meta_len = len(run.meta_pkt)

    def depth():
        return 1 if len(rate.pts) < 2 else _env_int("DSV1_PREFETCH", 2)

    def feed(pkt, quals, n_real):
        for nbytes, nf in gop_bytes(pkt, meta_len, n_real, G):
            rate.gop_done(quals[1], nbytes, nf)

    chunks = _chunks(frames, C, G)
    sched = (((c, (None, None)) for c in chunks) if rate is None
             else _pipelined(chunks, lambda _c: rate.gop_quants(), depth))
    for (f0, rows, n_real), (quants, quals) in sched:
        STATS["chunks"] += 1
        mots, _al, hr = run.motion(rows)
        stable = run.stability(st, mots, hr, n_real)
        res = run.chain(st, mots, hr, stable, quants=quants)
        if not any(r.overflow for r in res) and not calibrated:
            calibrated = True
            STATS["calibration_gop"] = f0 // G
            trial, _ = run.pack(res, fnum_base + f0, prev_link, n_real)
            feed(trial, quals, n_real)
            quants, quals = rate.gop_quants()
            res = run.chain(st, mots, hr, stable, quants=quants)
        pkt, prev_link = run.pack(res, fnum_base + f0, prev_link, n_real)
        out.extend(pkt)
        if rate is not None:
            feed(pkt, quals, n_real)
    return out, prev_link


def _encode_abr_exact(frames, cfg: EncoderConfig, meta: Metadata,
                      run: _GopRunner, st: EncoderState,
                      fnum_base: int) -> tuple:
    """The reference's per-frame ABR law, one GOP at a time (the JAX
    package's chunk is a serial scan over its GOPs, so its bytes do not
    depend on the chunk): (stream bytes without EOS, last picture
    length)."""
    law = rc.make_abr_law(cfg, meta)
    out = bytearray()
    prev_link = 0
    for f0, rows, n_real in _chunks(frames, 1, cfg.gop, pad=False):
        STATS["chunks"] += 1
        mots, al_h, hr = run.motion(rows)
        forced_i = False
        if cfg.do_scd:
            # the GOP's I frame is a scene cut against the previous frame
            # (the zero-initialised luma before frame 0) and so counts as
            # forced intra for the law (dsv_encoder.c:538-554, 133-141)
            forced_i = abs(int(al_h[0, 0]) - st.prev_al) \
                > cfg.scene_change_delta
            st.prev_al = int(al_h[0, -1])
        stable = run.stability(st, mots, hr, n_real)
        res = run.chain(st, mots, hr, stable, law=law, forced_i=forced_i)
        pkt, prev_link = run.pack(res, fnum_base + f0, prev_link, n_real)
        out.extend(pkt)
    return out, prev_link


def gops_per_chunk(cfg: EncoderConfig, w: int, h: int, n_frames: int = 0,
                   gops_per_device: int = 0) -> int:
    """GOPs a chunk (a launch of each kernel), the JAX package's rule:
    gops_per_device, else DSV1_GOPS_PER_DEVICE, else as many GOPs as fit
    the pixels of 4 CIF GOPs of 12 frames, at most 4 and at most the
    GOPs of the input where its length is known; 1 under ABR unless
    gops_per_device is given."""
    G = cfg.gop
    known = div_round(n_frames, G) if n_frames else 0
    per = gops_per_device or _env_int("DSV1_GOPS_PER_DEVICE", 0) or max(
        1, min(4, (4 * 352 * 288 * 12) // max(G * w * h, 1),
               known or (1 << 30)))
    if cfg.rc_mode != RATE_CONTROL_CRF and not gops_per_device:
        per = 1   # rate feedback per GOP beats batch width
    return per


def encode_stream_gops(frames, meta: Metadata,
                       cfg: EncoderConfig | None = None, device="cuda",
                       gops_per_device: int = 0, *, mesh: Mesh | None = None,
                       abr_mode: str = "exact", _fnum_base: int = 0,
                       _emit_eos: bool = True, _return_state: bool = False,
                       _stab_init: tuple | None = None):
    """Encode (y, u, v) uint8 frames (any iterable, read chunk by chunk)
    into a full .dsv stream on `device`. CRF (gop 0 included: intra
    only), or ABR: with the reference's per-frame law (abr_mode "exact")
    or GOP-granular (abr_mode "gop"). Byte-identical to the JAX
    package's encode_stream_gops for the same frames, config and
    arguments, effort 1..3 (the wider level-0 motion search, ops/hme.py
    hme_batch) included.

    gops_per_device: GOPs a chunk, each chunk's GOPs through one launch
    of each kernel per frame index (`gops_per_chunk`: 0 takes the JAX
    package's rule, up to 4 for frames of CIF size; 1 under ABR). Under
    GOP-granular ABR a chunk's GOPs share one quality, so the chunk
    changes the bytes, as in the JAX package; per-frame ABR runs one GOP
    at a time whatever the argument (its bytes do not depend on it).

    mesh: a GOP mesh (`gop_mesh`) or a gop x tile mesh (`gop_tile_mesh`),
    whose devices take `device`'s place (the JAX package's `mesh`
    argument): a chunk is gops_per_device GOPs for each index of the
    'gop' axis, split contiguously over it; each row of the mesh runs
    its GOPs' motion, recon chain, compaction and read on its first
    device, a gop x tile row its subband transforms in column tiles over
    its devices (parallel/tile.py). The bytes are those of one device
    at that chunk. gop 0 ignores the mesh (on its first device), as the
    JAX package's intra path does.

    The underscore arguments serve the sharded path
    (parallel/multihost.py): a frame-number offset, no EOS for a partial
    stream, and with `_return_state` the return value (stream, last
    picture length, (stability (nblk, 2) int32, refresh counter)) after
    the last frame; `_stab_init` is such a state (the port's or a JAX
    EncodedShard.stab_final) to start from. Per-frame ABR ignores
    `_stab_init`, as the JAX package does. Raises the JAX package's
    ValueError for ABR at gop 0, for gop > 4096 (the sequential `Encoder`
    runs those), for per-frame ABR with a mesh or `_return_state`, and
    for a mesh with a 'tile' axis but no 'gop' axis."""
    cfg = cfg or EncoderConfig()
    if mesh is not None and "tile" in mesh.axis_names \
            and "gop" not in mesh.axis_names:
        raise ValueError("mesh has a 'tile' axis but no 'gop' axis; "
                         "build it with gop_tile_mesh(n_gop, n_tile)")
    rows = None if mesh is None else gop_rows(mesh)
    dev = resolve(device) if mesh is None else rows[0][0]
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
    exact = abr and abr_mode == "exact"
    if exact and (mesh is not None or _return_state):
        raise ValueError("exact per-frame ABR is a serial rate chain (single "
                         "device); use abr_mode='gop' for meshes / shard "
                         "state")
    w, h, subsamp = meta.width, meta.height, meta.subsamp
    st = None
    if cfg.gop == GOP_INTRA:
        out, prev_link = _encode_intra(frames, meta, cfg, dev, _fnum_base)
    else:
        G = cfg.gop
        encs = [build_gop_encoder(subsamp, w, h, G, cfg.quality, cfg.do_scd,
                                  cfg.scene_change_delta,
                                  cfg.intra_pct_thresh, cfg.stable_refresh,
                                  cfg.pyramid_levels, str(r[0]),
                                  cfg.max_quality if abr else None,
                                  cfg.effort,
                                  tuple(str(d) for d in r) if len(r) > 1
                                  else ())
                for r in (rows or [[dev]])]
        nblk = encs[0].nbh * encs[0].nbv
        init = None if exact else _stab_init
        st = EncoderState(
            stability=torch.from_numpy(
                np.zeros((nblk, 2), np.int32) if init is None else
                np.array(init[0], np.int32).reshape(nblk, 2)).to(dev),
            refresh_ctr=0 if init is None else int(init[1]), prev_al=0,
            ref_recon=None,
            rc=rc.init_state(cfg.quality, dev) if exact else None)
        if exact:
            out, prev_link = _encode_abr_exact(
                frames, cfg, meta, _GopRunner(encs, meta, 1), st, _fnum_base)
        else:
            per = gops_per_chunk(cfg, w, h, len(frames) if hasattr(
                frames, "__len__") else 0, gops_per_device)
            out, prev_link = _encode_chunks(
                frames, G, per * len(encs), _GopRunner(encs, meta, per), st,
                _fnum_base, _AbrState(cfg, meta) if abr else None)
    with record_function("encode.finish"):
        if st is None:
            nblk = block_geometry(w, h)[2] * block_geometry(w, h)[3]
            state = (np.zeros((nblk, 2), np.int32), 0)
        else:
            state = (to_host(st.stability).astype(np.int32),
                     int(st.refresh_ctr))
        if _emit_eos:
            out.extend(encode_eos_packet(prev_link))
        out = bytes(out)
    if _return_state:
        return out, prev_link, state
    return out
