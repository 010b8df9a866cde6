"""The host parse of each decode request's stream (`decode.parse` spans)
per decoded frame."""

from harness import hostspans


def read(t):
    return hostspans.spans_ms_per_frame(t, "decode", "decode.parse")
