"""The intra-only encode (gop 0 under CRF), one frame after another:
what the JAX package's gop-0 branch of encode_stream_gops writes, in
the plainest order."""

import numpy as np
import torch

from dsvref import encode_stream_gops as gop_encode
from dsvref.constants import GOP_INTRA, RATE_CONTROL_CRF
from dsvref.device import resolve
from dsvref.models.bitstream import (encode_eos_packet,
                                     encode_metadata_packet,
                                     set_link_offsets)
from dsvref.models.encoder import (EncoderConfig, block_geometry,
                                   coef_geometry, crf_quant, pack_picture)
from dsvref.ops.hzcc import encode_plane_core_plain, runs_from_qvals

from .ops import sbt


def centred(plane, cw: int, ch: int):
    """An intra plane (h, w) u8 as its (ch, cw) int32 coefficients (p2sbc,
    dsv_encoder.c:505-526): each sample less 128, the edge column repeated
    where cw exceeds w, zero on rows below h."""
    h, w = plane.shape
    out = torch.zeros((ch, cw), dtype=torch.int32, device=plane.device)
    v = plane.to(torch.int32) - 128
    out[:h, :w] = v
    out[:h, w:cw] = v[:, w - 1:w]
    return out


def encode_intra(frames, meta, quality: int, dev) -> bytes:
    """The stream of frames (y, u, v) u8 at gop 0 and CRF `quality`."""
    w, h, subsamp = meta.width, meta.height, meta.subsamp
    blk_w, blk_h, nbh, nbv = block_geometry(w, h)
    _layout, dims, tables = coef_geometry(subsamp, w, h, nbh, nbv)
    quant = crf_quant(quality)
    stable = torch.ones(nbh * nbv, dtype=torch.uint8, device=dev)
    stable_h = np.ones(nbh * nbv, np.uint8)
    meta_pkt = bytes(encode_metadata_packet(meta))
    out = bytearray()
    prev_link = 0
    for fno, planes in enumerate(frames):
        syms, dcs = [], []
        for c, plane in enumerate(planes[:3]):
            p = torch.tensor(np.asarray(plane, np.uint8), device=dev)
            coefs = sbt.fwd_intra(centred(p, *dims[c]))
            qvals, _wb = encode_plane_core_plain(coefs, quant, False, c,
                                                 stable, tables[c])
            syms.append(runs_from_qvals(qvals.cpu().numpy()))
            dcs.append(int(coefs[0, 0]))
        pic = pack_picture(fno, blk_w, blk_h, stable_h, False, False, None,
                           quant, syms, dcs, nbh, nbv)
        set_link_offsets(pic, prev_link, len(pic))
        prev_link = len(pic)
        out += meta_pkt
        out += pic
    out += encode_eos_packet(prev_link)
    return bytes(out)


def encode_stream_gops(frames, meta, cfg: EncoderConfig | None = None,
                       device="cuda") -> bytes:
    """Encode (y, u, v) uint8 frames into a full .dsv stream on `device`:
    gop 0 under CRF here, every other configuration by dsvref. Raises
    ValueError for ABR at gop 0, which neither encodes."""
    cfg = cfg or EncoderConfig()
    if cfg.gop != GOP_INTRA:
        return gop_encode(frames, meta, cfg, device)
    if cfg.rc_mode != RATE_CONTROL_CRF:
        raise ValueError("the reference encodes gop 0 under CRF only")
    return encode_intra(frames, meta, cfg.quality, resolve(device))
