"""The decode chunks' host rows, scatter and uploads (`decode.upload`
spans) per decoded frame."""

from harness import hostspans


def read(t):
    return hostspans.spans_ms_per_frame(t, "decode", "decode.upload")
