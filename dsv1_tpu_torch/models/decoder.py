"""The sequential decoder (mirror of dsv1_tpu/models/decoder.py).

One packet per `decode_packet` call, with the reference decoder's API
and return codes (dsv_decoder.h:52-59). A picture is parsed on the host
by the native parser (parallel/decode.py `_parse_picture`: header,
stability and motion substreams, HZCC symbols) and reconstructed on the
device by the chain decoder's step (`GopDecoder.step`: dequantization,
inverse transforms, the MC kernel and the residual add for P pictures).
The last reference picture is kept across chains and replaced only by
is_ref pictures (dsv_decoder.c:422-456); the chain decoder is cached
per geometry, so a metadata packet that changes the geometry is
honoured. With `draw_info` the overlay (models/overlay.py) is drawn on
P pictures.
"""

from ..constants import PT_EOS, PT_META, pt_is_pic

from ..device import resolve
from ..parallel.decode import _parse_picture, build_gop_decoder
from .bitstream import iter_packets, parse_metadata, parse_packet_hdr
from .metadata import Metadata
from .overlay import draw_info as _draw

DEC_OK = 0
DEC_ERROR = 1
DEC_EOS = 2
DEC_GOT_META = 3


class Decoder:
    """Mirrors the reference decoder API (dsv_decoder.h:52-59)."""

    def __init__(self, draw_info: int = 0, device="cuda"):
        self.device = resolve(device)
        self.meta: Metadata | None = None
        self.got_metadata = False
        self.draw_info = draw_info
        # (subsamp, width, height) and flat device image of the last
        # reference picture
        self._ref = None

    def get_metadata(self) -> Metadata | None:
        return self.meta

    def decode_packet(self, data: bytes):
        """Returns (code, planes or None, fnum); planes: 3 numpy u8
        arrays."""
        try:
            pkt_type = parse_packet_hdr(data)
        except ValueError:
            return DEC_ERROR, None, -1
        if not pt_is_pic(pkt_type):
            if pkt_type == PT_META:
                self.meta = parse_metadata(data)
                self.got_metadata = True
                return DEC_GOT_META, None, -1
            if pkt_type == PT_EOS:
                return DEC_EOS, None, -1
            return DEC_ERROR, None, -1
        if not self.got_metadata:
            return DEC_OK, None, -1
        try:
            pic = _parse_picture(data, self.meta)
        except (IndexError, ValueError):
            # corrupt/truncated picture: the reference tolerates these via
            # in-stream guards (hzcc.c:337-339, dsv_decoder.c:398-401)
            return DEC_ERROR, None, -1
        return self._decode_picture(pic)

    def _decode_picture(self, pic):
        meta = self.meta
        key = (meta.subsamp, meta.width, meta.height)
        if pic["has_ref"] and (self._ref is None or self._ref[0] != key):
            return DEC_ERROR, None, -1
        dec = build_gop_decoder(*key, pic["blk_w"], pic["blk_h"],
                                str(self.device))
        ref = self._ref[1] if self._ref is not None else None
        new_ref, outs = dec.step(ref, dec.qdense([pic])[0], pic)
        if pic["is_ref"]:
            self._ref = (key, new_ref)
        (planes,) = dec.planes_to_host([outs])
        if self.draw_info and pic["has_ref"]:
            # the parsed stable blocks carry the intra bit
            # (stable |= (modes == MODE_INTRA) << 1, dsv_decoder.c)
            planes = _draw(planes, pic["stable"], pic["modes"], pic["mvx"],
                           pic["mvy"], pic["submask"], pic["blk_w"],
                           pic["blk_h"], dec.nbh, dec.nbv, self.draw_info)
        return DEC_OK, planes, pic["fno"]

    def decode_stream(self, stream: bytes):
        """Iterate the decoded frames of a .dsv byte stream -> (fnum,
        planes)."""
        for _t, pkt in iter_packets(stream):
            code, planes, fno = self.decode_packet(pkt)
            if code == DEC_EOS:
                return
            if code == DEC_OK and planes is not None:
                yield fno, planes
