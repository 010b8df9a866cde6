"""Percent of the intra-only path's chunks whose compacted planes
overflowed their cap and were read back dense (the program's
`overflow_redos` over its `intra_chunks`)."""


def read(t):
    chunks = t.counters.get("intra_chunks", 0)
    if t.op != "encode" or not t.frames or not chunks:
        return None
    return 100.0 * t.counters.get("overflow_redos", 0) / chunks
