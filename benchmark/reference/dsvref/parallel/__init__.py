"""GOP-parallel encode and decode on one device."""

from .decode import decode_stream_gops
from .gop import encode_stream_gops

__all__ = ["decode_stream_gops", "encode_stream_gops"]
