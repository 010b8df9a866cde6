"""The blocking device-to-host reads of the decode chunks' planes
(`decode.read` spans) per decoded frame."""

from harness import hostspans


def read(t):
    return hostspans.spans_ms_per_frame(t, "decode", "decode.read")
