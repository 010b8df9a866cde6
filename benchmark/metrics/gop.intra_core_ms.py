"""The host time of the intra-only path's core (`gop.intra_core` spans:
the prep and the frames' encode-core calls) per encoded frame, less any
`encode.read` span inside them (a tree whose `gop.intra_core` also wraps
the compaction and both reads)."""

from harness.trace import clip, union


def read(t):
    core = [(a, b) for n, a, b in t.spans if n == "gop.intra_core"]
    if t.op != "encode" or not t.frames or not core:
        return None
    reads = [(a, b) for n, a, b in t.spans if n == "encode.read"]
    inside = sum(union(clip(reads, a, b)) for a, b in core)
    return (sum(b - a for a, b in core) - inside) * 1e-3 / t.frames
