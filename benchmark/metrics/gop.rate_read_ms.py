"""The per-frame ABR quality read (`gop.rate_read` spans) per encoded
frame; nothing to read under CRF."""

from harness import readers


def read(t):
    return readers.span_ms_per_frame(t, "encode", "gop.rate_read")
