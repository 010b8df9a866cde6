"""GOP-parallel encode and decode on one device."""

from .decode import build_gop_decoder, decode_stream_gops, iter_decode_gops
from .gop import build_gop_encoder, encode_stream_gops

__all__ = ["build_gop_decoder", "build_gop_encoder", "decode_stream_gops",
           "encode_stream_gops", "iter_decode_gops"]
