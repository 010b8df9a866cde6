"""The intra-only path's host scan of overflowed pictures' dense planes
into (run, value) symbols (`gop.intra_scan` spans, inside `gop.pack`)
per encoded frame."""

from harness import hostspans


def read(t):
    return hostspans.spans_ms_per_frame(t, "encode", "gop.intra_scan")
