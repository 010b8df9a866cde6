"""The dispatch of the decode chunks' frame steps (`decode.chain` spans:
dequantization, inverse transforms, motion compensation) per decoded
frame."""

from harness import hostspans


def read(t):
    return hostspans.spans_ms_per_frame(t, "decode", "decode.chain")
