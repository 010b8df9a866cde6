"""Packet-level bitstream: headers, metadata, EOS, link offsets, demux.

Wire format (reference B.1/B.2): every packet starts with
  'DSV1' | u8 version | u8 type | u32 prev-link | u32 next-link
(dsv.h:27-47). Metadata packets carry UEG-coded dimensions/format/rates
(dsv_encoder.c:427-461); the next-link doubles as the packet size for
stream demux (dsv_main.c:567-612). The port's copy of
dsv1_tpu/models/bitstream.py.
"""

import numpy as np

from ..constants import (FOURCC, PACKET_HDR_SIZE, PACKET_NEXT_OFFSET,
                         PACKET_PREV_OFFSET, PACKET_TYPE_OFFSET, PT_EOS,
                         PT_META, VERSION_MINOR)
from ..ops.golomb import BitReader, BitWriter
from .metadata import Metadata


def write_packet_hdr(w: BitWriter, pkt_type: int):
    """encode_packet_hdr (dsv_encoder.c:410-424)."""
    for b in FOURCC:
        w.put_bits(8, b)
    w.put_bits(8, VERSION_MINOR)
    w.put_bits(8, pkt_type)
    w.put_bits(32, 0)  # prev link (patched at emit)
    w.put_bits(32, 0)  # next link


def parse_packet_hdr(data: bytes) -> int:
    """Returns packet type; raises on bad fourcc (dsv_decoder.c:21-48)."""
    if data[:4] != FOURCC:
        raise ValueError(f"bad fourcc {data[:4]!r}")
    return data[PACKET_TYPE_OFFSET]


def set_link_offsets(packet: bytearray, prev_link: int, next_link: int):
    """B.1 link offsets (dsv_encoder.c:171-192)."""
    packet[PACKET_PREV_OFFSET:PACKET_PREV_OFFSET + 4] = prev_link.to_bytes(4, "big")
    packet[PACKET_NEXT_OFFSET:PACKET_NEXT_OFFSET + 4] = next_link.to_bytes(4, "big")


def encode_metadata_packet(meta: Metadata) -> bytearray:
    """B.2.1 metadata packet (dsv_encoder.c:427-461)."""
    w = BitWriter(2048)
    write_packet_hdr(w, PT_META)
    for v in (meta.width, meta.height, meta.subsamp, meta.fps_num,
              meta.fps_den, meta.aspect_num, meta.aspect_den):
        w.put_ueg(int(v))
    w.align()
    buf = bytearray(w.getvalue())
    buf[PACKET_NEXT_OFFSET:PACKET_NEXT_OFFSET + 4] = len(buf).to_bytes(4, "big")
    return buf


def parse_metadata(data: bytes) -> Metadata:
    """B.2.1 metadata decode (dsv_decoder.c:51-70)."""
    r = BitReader(data[PACKET_HDR_SIZE:])
    vals = [r.get_ueg() for _ in range(7)]
    return Metadata(*vals)


def encode_eos_packet(prev_link: int) -> bytearray:
    """B.2.2 end-of-stream packet (dsv_encoder.c:766-778)."""
    w = BitWriter(256)
    write_packet_hdr(w, PT_EOS)
    buf = bytearray(w.getvalue())
    set_link_offsets(buf, prev_link, 0)
    return buf


def iter_packets(stream: bytes, strict: bool = False):
    """Demux a .dsv byte stream -> yields (pkt_type, packet_bytes).

    Uses the next-link as the packet size like the reference driver
    (dsv_main.c:567-612). Like that driver — which simply stops at a
    short read and never validates mid-stream bytes itself — a
    truncated or corrupt tail ends the iteration; the final partial
    packet is still yielded so the decoder's in-stream guards
    (hzcc.c:337-339) can salvage what is there. strict=True restores
    hard errors for tooling that wants them.
    """
    off = 0
    n = len(stream)
    while off + PACKET_HDR_SIZE <= n:
        hdr = stream[off:off + PACKET_HDR_SIZE]
        if hdr[:4] != FOURCC:
            if strict:
                raise ValueError(f"bad fourcc at offset {off}")
            return
        size = int.from_bytes(hdr[PACKET_NEXT_OFFSET:PACKET_NEXT_OFFSET + 4],
                              "big")
        if size == 0:
            size = PACKET_HDR_SIZE
        if size < PACKET_HDR_SIZE:
            if strict:
                raise ValueError(f"bad packet size {size} at offset {off}")
            return
        if off + size > n:
            if strict:
                raise ValueError(f"bad packet size {size} at offset {off}")
            yield hdr[PACKET_TYPE_OFFSET], stream[off:]  # truncated tail
            return
        yield hdr[PACKET_TYPE_OFFSET], stream[off:off + size]
        if hdr[PACKET_TYPE_OFFSET] == PT_EOS:
            return
        off += size
