"""The host packing of chunks (`gop.pack` spans) per encoded frame."""

from harness import readers


def read(t):
    return readers.span_ms_per_frame(t, "encode", "gop.pack")
