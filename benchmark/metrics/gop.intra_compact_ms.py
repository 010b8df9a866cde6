"""The host time of the intra-only path's compaction (`gop.intra_compact`
spans: the `compact_dense_i` launches and the stacking of the parts read
back) per encoded frame."""

from harness import hostspans


def read(t):
    return hostspans.spans_ms_per_frame(t, "encode", "gop.intra_compact")
