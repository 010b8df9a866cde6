"""The motion search of chunks (`gop.motion` spans) per encoded frame."""

from harness import readers


def read(t):
    return readers.span_ms_per_frame(t, "encode", "gop.motion")
