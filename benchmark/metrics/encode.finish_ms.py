"""The end of each encode request (`encode.finish` spans: the stability
state's read, the EOS, the stream's copy) per encoded frame."""

from harness import hostspans


def read(t):
    return hostspans.spans_ms_per_frame(t, "encode", "encode.finish")
