"""GOP-parallel decode (mirror of dsv1_tpu/parallel/decode.py).

The host (native/dsvbits.cpp + numpy) demuxes packets and parses each
picture: header fields, stability ZBRLE, motion substreams and the HZCC
symbols, with band aliases resolved last-wins (the reference's visit
order). A chain of pictures (an I frame and the P frames that follow
it) depends on nothing outside itself, so chains are decoded in chunks,
as the JAX package batches them (`GopDecoder.start`, `frame` and
`finish`; the JAX rule in `chains_per_device`: up to 4 chains a chunk
at CIF, one at 1080p). Per
chunk one scatter builds every picture's quantized grids and one upload
carries the pictures' DCs, quants, stable blocks and motion fields;
then frame index by frame index the chunk's pictures of one type go
through the device together: dequantization and the inverse subband
transforms with a quant per picture (an ABR stream carries one per
picture), one launch of the MC kernel for the P pictures' predictions,
the residual add; only is_ref pictures replace their chain's reference
(dsv_decoder.c:422-456). A chunk's decoded planes come back in one
device-to-host copy. With a mesh a chunk is `chains_per_device` chains
for each device, split contiguously; frame index by frame index each
device's chains are dispatched in turn, so distinct devices overlap.
`iter_decode_gops` holds one chunk of decoded frames; a stream whose
block size changes mid-stream goes to the sequential
`models.decoder.Decoder`.
"""

from functools import lru_cache

import numpy as np
import torch

from .. import bits
from ..constants import (MAX_BLOCK_SIZE, MAX_QP_BITS, MIN_BLOCK_SIZE,
                         PT_EOS, PT_META, div_round, pt_is_pic,
                         pt_is_ref)
from ..models.bitstream import (iter_packets, parse_metadata,
                                parse_packet_hdr)
from ..models.metadata import Metadata

from ..device import resolve
from ..models.encoder import coef_geometry, split_row
from ..ops import bmc, frame as fr, hzcc, sbt
from ..utils.stats import STATS
from .mesh import Mesh


class _Chunk:
    """A chunk of chains being decoded on one device: the quantized grids
    (C, L, N), the pictures' small fields (C, L, X) int32, the reference
    images (C, n) and the decoded planes (C, L, P) u8."""

    def __init__(self, chains, qd, meta, refs, out):
        self.chains, self.qd, self.meta = chains, qd, meta
        self.refs, self.out = refs, out


class GopDecoder:
    """Decodes chains of pictures of one geometry on one device."""

    def __init__(self, subsamp: int, w: int, h: int, blk_w: int,
                 blk_h: int, device="cuda"):
        self.device = resolve(device)
        self.blk_w, self.blk_h = blk_w, blk_h
        self.nbh, self.nbv = div_round(w, blk_w), div_round(h, blk_h)
        self.nblk = self.nbh * self.nbv
        self.layout, self.coef_dims, self.tables = coef_geometry(
            subsamp, w, h, self.nbh, self.nbv)
        self.nper = [ch * cw for (cw, ch) in self.coef_dims]
        self.N = sum(self.nper)
        self.offs = [0, self.nper[0], self.nper[0] + self.nper[1]]
        self.psizes = [p.h * p.w for p in self.layout.planes]

    # columns of a picture's row of small fields
    _DC, _Q = 0, 3

    def _fields(self, pic) -> np.ndarray:
        """A picture's small fields as one int32 row: the three DCs, the
        quant, then the stable blocks, modes, mvx, mvy and submask
        (nblk each)."""
        return np.concatenate([
            np.asarray(pic["dcs"], np.int32), [np.int32(pic["quant"])],
            *(np.asarray(pic[k], np.int32).reshape(-1) for k in
              ("stable", "modes", "mvx", "mvy", "submask"))])

    def group(self, refs, qgrids, meta, is_p: bool):
        """G pictures of one type through the device together: refs (G,
        n) their chains' reference images (ignored for I pictures),
        qgrids (G, N) their quantized grids, meta (G, X) their small
        fields. Returns (the new images (G, n), the (y, u, v) planes, each
        (G, h, w)). P pictures take one MC launch."""
        G, nb = qgrids.shape[0], self.nblk
        quant = meta[:, self._Q]
        stable = meta[:, 4:4 + nb]
        if is_p:
            STATS["decode_p"] += G
            STATS["decode_p_calls"] += 1
            mv = [meta[:, 4 + k * nb:4 + (k + 1) * nb].contiguous()
                  for k in (1, 2, 3, 4)]
            preds = bmc.compensate_frame(refs, self.layout, self.blk_w,
                                         self.blk_h, self.nbh, self.nbv,
                                         *mv)
        outs = []
        for c in range(3):
            p = self.layout.planes[c]
            cw, ch = self.coef_dims[c]
            qgrid = qgrids[:, self.offs[c]:self.offs[c] + self.nper[c]] \
                .reshape(G, ch, cw)
            coefs = hzcc.dequant_plane_grid(qgrid, meta[:, self._DC + c],
                                            quant, is_p, c, stable,
                                            self.tables[c])
            rp = sbt.coefs_to_plane(sbt.inv_sbt(
                coefs, quant, is_p, is_luma=(c == 0)))[:, :p.h, :p.w]
            if is_p:
                rp = bmc.add_residual(preds[c], rp)
            outs.append(rp)
        return fr.image_from_planes(self.layout, outs), outs

    def step(self, ref_img, qflat, pic):
        """One picture: returns (new reference image, (y, u, v) planes)."""
        meta = torch.from_numpy(self._fields(pic)[None]).to(self.device)
        new, outs = self.group(None if ref_img is None else ref_img[None],
                               qflat[None], meta, bool(pic["has_ref"]))
        return (new[0] if pic["is_ref"] else ref_img), [o[0] for o in outs]

    def qdense(self, pics):
        """(L, N) int32 quantized grids of L parsed pictures, one scatter
        on the device."""
        return self._scatter([pics], len(pics))[0]

    def _scatter(self, chains, L: int):
        """(C, L, N) int32 quantized grids of C chains of up to L
        pictures, one scatter on the device."""
        dev, N = self.device, self.N
        sidx, sval = [], []
        for ci, pics in enumerate(chains):
            for k, f in enumerate(pics):
                for c in range(3):
                    sidx.append((ci * L + k) * N + self.offs[c]
                                + f["sidx"][c].astype(np.int64))
                    sval.append(f["sval"][c].astype(np.int32))
        qd = torch.zeros(len(chains) * L * N, dtype=torch.int32, device=dev)
        if sidx:
            qd[torch.from_numpy(np.concatenate(sidx)).to(dev)] = \
                torch.from_numpy(np.concatenate(sval)).to(dev)
        return qd.reshape(len(chains), L, N)

    def planes_to_host(self, planes):
        """[(y, u, v) device planes] of L pictures -> [[y, u, v]] numpy
        planes, one fetch."""
        host = torch.stack([torch.cat([o.reshape(-1) for o in outs])
                            for outs in planes]).cpu().numpy()
        return [self._split(row) for row in host]

    def _split(self, row):
        ps = self.layout.planes
        return [a.reshape(p.h, p.w) for a, p in
                zip(split_row(row, self.psizes), ps)]

    def start(self, chains) -> _Chunk:
        """Uploads a chunk of chains (lists of parsed pictures): their
        grids in one scatter, their small fields in one copy."""
        L = max(len(ch) for ch in chains)
        dev = self.device
        rows = np.zeros((len(chains), L, 4 + 5 * self.nblk), np.int32)
        for ci, pics in enumerate(chains):
            for k, f in enumerate(pics):
                rows[ci, k] = self._fields(f)
        return _Chunk(chains, self._scatter(chains, L),
                      torch.from_numpy(rows).to(dev),
                      fr.alloc_image(self.layout, device=dev)
                      .repeat(len(chains), 1),
                      torch.empty((len(chains), L, sum(self.psizes)),
                                  dtype=torch.uint8, device=dev))

    def frame(self, st: _Chunk, k: int):
        """Frame index k of a chunk: its pictures of each type through
        `group` together (at most two groups: a chain that starts on a P
        picture mixes types at k = 0 only)."""
        live = [ci for ci, pics in enumerate(st.chains) if len(pics) > k]
        for is_p in (False, True):
            sel = [ci for ci in live if bool(st.chains[ci][k]["has_ref"])
                   == is_p]
            if not sel:
                continue
            whole = len(sel) == len(st.chains)
            idx = None if whole else torch.tensor(sel, device=self.device)

            def take(t):
                return t if whole else t.index_select(0, idx)
            new, outs = self.group(take(st.refs), take(st.qd[:, k]),
                                   take(st.meta[:, k]), is_p)
            flat = torch.cat([o.reshape(len(sel), -1) for o in outs], -1)
            if whole:
                st.out[:, k] = flat
            else:
                st.out[:, k].index_copy_(0, idx, flat)
            ref = [j for j, ci in enumerate(sel)
                   if st.chains[ci][k]["is_ref"]]
            if len(ref) == len(st.chains):
                st.refs = new
            elif ref:
                st.refs.index_copy_(0, torch.tensor(
                    [sel[j] for j in ref], device=self.device),
                    new.index_select(0, torch.tensor(ref,
                                                     device=self.device)))

    def finish(self, st: _Chunk):
        """The chunk's decoded planes, one fetch: per chain [[y, u, v]]
        numpy planes."""
        host = st.out.cpu().numpy()
        return [[self._split(host[ci, k]) for k in range(len(pics))]
                for ci, pics in enumerate(st.chains)]


@lru_cache(maxsize=8)
def build_gop_decoder(subsamp: int, w: int, h: int, blk_w: int, blk_h: int,
                      device: str = "cuda"):
    """The chain decoder for one geometry (cached)."""
    return GopDecoder(subsamp, w, h, blk_w, blk_h, device)


@lru_cache(maxsize=16)
def _plane_caps(subsamp: int, w: int, h: int):
    """Per-plane traversal sizes (symbol caps)."""
    _, _, tables = coef_geometry(subsamp, w, h, 1, 1)
    return tuple(t.n for t in tables)


def _parse_picture(data: bytes, meta: Metadata):
    """Host parse of one picture packet -> dict (dsv_decoder.c:286-412),
    quantized symbols as grid indices with band aliases resolved
    last-wins."""
    pkt_type = parse_packet_hdr(data)
    hdr, stable, modes, mvx, mvy, submask, planes = bits.parse_picture(
        data, meta.width, meta.height, MAX_QP_BITS,
        MIN_BLOCK_SIZE, MAX_BLOCK_SIZE,
        _plane_caps(meta.subsamp, meta.width, meta.height))
    _, coef_dims, tables = coef_geometry(meta.subsamp, meta.width,
                                         meta.height, hdr["nbh"], hdr["nbv"])
    sidx, sval, dcs = [], [], []
    for c in range(3):
        cw, ch = coef_dims[c]
        dc, runs, vals, plen = planes[c]
        if plen <= 0 or plen > cw * ch * 4 * 2:
            raise ValueError("bad plane length")
        if runs.size:
            pos = np.cumsum(runs.astype(np.int64) + 1) - 1
            keep = pos < tables[c].n
            v = vals[:runs.size][keep]
            idx = tables[c].perm[pos[keep]].astype(np.int32)
            u, last_rev = np.unique(idx[::-1], return_index=True)
            sidx.append(u)
            sval.append(v.astype(np.int32)[::-1][last_rev])
        else:
            sidx.append(np.zeros(0, np.int32))
            sval.append(np.zeros(0, np.int32))
        dcs.append(dc)
    return dict(fno=hdr["fno"], blk_w=hdr["blk_w"], blk_h=hdr["blk_h"],
                has_ref=hdr["has_ref"], is_ref=pt_is_ref(pkt_type),
                quant=hdr["quant"], stable=stable, modes=modes, mvx=mvx,
                mvy=mvy, submask=submask, sidx=sidx, sval=sval,
                dcs=np.asarray(dcs, np.int32))


def _plan_stream(frames):
    """Chains of picture indices: every no-ref picture starts one."""
    chains = []
    for i, f in enumerate(frames):
        if not f["has_ref"] or not chains:
            chains.append([i])
        else:
            chains[-1].append(i)
    return chains


def chains_per_device(chains, w: int, h: int) -> int:
    """Chains a device decodes together, the JAX package's rule
    (dsv1_tpu/parallel/decode.py:239-240): as many as fit the pixels of 4
    CIF chains of 12 pictures, with L the longest chain's length, at
    most 4 and at most the stream's chains."""
    L = max(len(c) for c in chains)
    return max(1, min(4, (4 * 352 * 288 * 12) // max(L * w * h, 1),
                      len(chains)))


def iter_decode_gops(stream: bytes, device="cuda", *, mesh: Mesh | None = None,
                     meta_box: dict | None = None):
    """Decode a .dsv stream in chunks of chains on `device` (or, with a
    GOP mesh, on its devices: a chunk is `chains_per_device` chains for
    each device, split contiguously), yielding (fno, [y, u, v]) numpy
    planes in stream order as each chunk is decoded. The whole stream is
    parsed first, so `meta_box["meta"]` (when a dict is given) holds the
    metadata before the first frame."""
    devs = ([resolve(device)] if mesh is None
            else list(mesh.devices.reshape(-1)))
    meta = None
    frames = []
    for _t, pkt in iter_packets(stream):
        try:
            t = parse_packet_hdr(pkt)
            if t == PT_META:
                meta = parse_metadata(pkt)
            elif t == PT_EOS:
                break
            elif pt_is_pic(t) and meta is not None:
                frames.append(_parse_picture(pkt, meta))
        except (ValueError, IndexError):
            # corrupt or truncated packet: skip it, like the reference's
            # in-stream guards (hzcc.c:337-339, dsv_decoder.c:398-401)
            continue
    if meta_box is not None:
        meta_box["meta"] = meta
    if meta is None or not frames:
        return
    if len({(f["blk_w"], f["blk_h"]) for f in frames}) != 1:
        # a block size that changes mid-stream: the sequential decoder
        # (as the JAX package falls back to its own)
        from ..models.decoder import Decoder
        yield from Decoder(device=devs[0]).decode_stream(stream)
        return
    chains = _plan_stream(frames)
    per_dev = chains_per_device(chains, meta.width, meta.height)
    decs = [build_gop_decoder(meta.subsamp, meta.width, meta.height,
                              frames[0]["blk_w"], frames[0]["blk_h"],
                              str(d)) for d in devs]
    chunk = per_dev * len(devs)
    for s in range(0, len(chains), chunk):
        parts = []
        for d, dec in enumerate(decs):
            sub = chains[s + d * per_dev:s + (d + 1) * per_dev]
            if sub:
                parts.append((dec, sub, dec.start(
                    [[frames[i] for i in ch] for ch in sub])))
        # frame index outermost, devices inside: distinct devices overlap
        for k in range(max(len(ch) for _d, sub, _s in parts for ch in sub)):
            for dec, _sub, st in parts:
                dec.frame(st, k)
        for dec, sub, st in parts:
            for ch, planes in zip(sub, dec.finish(st)):
                for i, p in zip(ch, planes):
                    yield frames[i]["fno"], p
                    frames[i] = None   # free the symbols as we go


def decode_stream_gops(stream: bytes, device="cuda", *,
                       mesh: Mesh | None = None):
    """Decode a .dsv stream in chunks of chains on `device`, or over a
    GOP mesh's devices. Returns (metadata, [(fno, [y, u, v]), ...] in
    stream order)."""
    meta_box = {}
    frames = list(iter_decode_gops(stream, device, mesh=mesh,
                                   meta_box=meta_box))
    return meta_box.get("meta"), frames
