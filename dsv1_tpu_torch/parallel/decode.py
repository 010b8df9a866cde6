"""GOP-parallel decode (mirror of the single-device path of
dsv1_tpu/parallel/decode.py).

The host (native/dsvbits.cpp + numpy) demuxes packets and parses each
picture: header fields, stability ZBRLE, motion substreams and the HZCC
symbols, with band aliases resolved last-wins (the reference's visit
order). Each chain of pictures (an I frame and the P frames that follow
it) is decoded on the device: one scatter builds the chain's quantized
grids, then per picture dequantization, inverse subband transforms,
motion compensation and the residual add, with the reference image
replaced only by is_ref pictures (dsv_decoder.c:422-456). The quant
is read per picture, so ABR streams (a quant per picture) decode like
CRF ones. `iter_decode_gops` yields each chain's frames as soon as the
chain is decoded, one device fetch per chain.
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
from ..models.encoder import coef_geometry
from ..ops import bmc, frame as fr, hzcc, sbt


class GopDecoder:
    """Decodes chains of pictures of one geometry on one device."""

    def __init__(self, subsamp: int, w: int, h: int, blk_w: int,
                 blk_h: int, device="cuda"):
        self.device = resolve(device)
        self.blk_w, self.blk_h = blk_w, blk_h
        self.nbh, self.nbv = div_round(w, blk_w), div_round(h, blk_h)
        self.layout, self.coef_dims, self.tables = coef_geometry(
            subsamp, w, h, self.nbh, self.nbv)
        self.nper = [ch * cw for (cw, ch) in self.coef_dims]
        self.N = sum(self.nper)
        self.offs = [0, self.nper[0], self.nper[0] + self.nper[1]]

    def step(self, ref_img, qflat, pic):
        """One picture: returns (new reference image, (y, u, v) planes)."""
        dev = self.device
        is_p = bool(pic["has_ref"])
        stable = torch.from_numpy(pic["stable"]).to(dev)
        if is_p:
            mv = torch.from_numpy(np.stack([
                pic[k].astype(np.int32)
                for k in ("modes", "mvx", "mvy", "submask")])).to(dev)
            preds = bmc.compensate_frame(ref_img, self.layout, self.blk_w,
                                         self.blk_h, self.nbh, self.nbv, *mv)
        outs = []
        for c in range(3):
            p = self.layout.planes[c]
            cw, ch = self.coef_dims[c]
            qgrid = qflat[self.offs[c]:self.offs[c] + self.nper[c]] \
                .reshape(ch, cw)
            coefs = hzcc.dequant_plane_grid(qgrid, int(pic["dcs"][c]),
                                            pic["quant"], is_p, c, stable,
                                            self.tables[c])
            rp = sbt.coefs_to_plane(sbt.inv_sbt(
                coefs, pic["quant"], is_p, is_luma=(c == 0)))[:p.h, :p.w]
            if is_p:
                rp = bmc.add_residual(preds[c], rp)
            outs.append(rp)
        new_img = fr.image_from_planes(self.layout, outs)
        return (new_img if pic["is_ref"] else ref_img), outs

    def decode_chain(self, pics):
        """Decode one chain of parsed pictures; returns [(y, u, v)] as
        numpy arrays, one fetch per chain."""
        dev = self.device
        L, N = len(pics), self.N
        sidx, sval = [], []
        for k, f in enumerate(pics):
            for c in range(3):
                sidx.append(k * N + self.offs[c] + f["sidx"][c]
                            .astype(np.int64))
                sval.append(f["sval"][c].astype(np.int32))
        qdense = torch.zeros(L * N, dtype=torch.int32, device=dev)
        qdense[torch.from_numpy(np.concatenate(sidx)).to(dev)] = \
            torch.from_numpy(np.concatenate(sval)).to(dev)
        qdense = qdense.reshape(L, N)
        ref = fr.alloc_image(self.layout, device=dev)
        planes = []
        for k, pic in enumerate(pics):
            ref, outs = self.step(ref, qdense[k], pic)
            planes.append(torch.cat([o.reshape(-1) for o in outs]))
        host = torch.stack(planes).cpu().numpy()
        sizes = [self.layout.planes[c].h * self.layout.planes[c].w
                 for c in range(3)]
        res = []
        for k in range(L):
            row, off, pl = host[k], 0, []
            for c in range(3):
                p = self.layout.planes[c]
                pl.append(row[off:off + sizes[c]].reshape(p.h, p.w))
                off += sizes[c]
            res.append(pl)
        return res


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
    if len({(f["blk_w"], f["blk_h"]) for f in frames}) != 1:
        raise NotImplementedError("mid-stream block-size change needs the "
                                  "sequential decoder, not ported")
    return chains


def iter_decode_gops(stream: bytes, device="cuda", *,
                     meta_box: dict | None = None):
    """Decode a .dsv stream chain by chain on `device`, yielding
    (fno, [y, u, v]) numpy planes in stream order as each chain is
    decoded. The whole stream is parsed first, so `meta_box["meta"]`
    (when a dict is given) holds the metadata before the first frame."""
    dev = resolve(device)
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
    chains = _plan_stream(frames)
    dec = build_gop_decoder(meta.subsamp, meta.width, meta.height,
                            frames[0]["blk_w"], frames[0]["blk_h"], str(dev))
    for ch in chains:
        pics = [frames[i] for i in ch]
        for f, planes in zip(pics, dec.decode_chain(pics)):
            yield f["fno"], planes
        for i in ch:
            frames[i] = None   # free the chain's symbols as we go


def decode_stream_gops(stream: bytes, device="cuda"):
    """Decode a .dsv stream chain by chain on `device`. Returns
    (metadata, [(fno, [y, u, v]), ...] in stream order)."""
    meta_box = {}
    frames = list(iter_decode_gops(stream, device, meta_box=meta_box))
    return meta_box.get("meta"), frames
