"""Megabytes (1e6 bytes) of dense int32 planes that the intra-only path
read back for its overflowed chunks (the program's `intra_dense_bytes`,
part of `d2h_bytes`) per encoded frame; 0 where no chunk of the path
overflowed."""


def read(t):
    if t.op != "encode" or not t.frames or "intra_chunks" not in t.counters:
        return None
    return t.counters.get("intra_dense_bytes", 0) * 1e-6 / t.frames
