"""Percent of the slice's chunks of GOPs whose compacted planes overflowed
their caps and were packed from the dense planes (the program's
`overflow_redos` over its `chunks`)."""


def read(t):
    chunks = t.counters.get("chunks", 0)
    if t.op != "encode" or not chunks:
        return None
    return 100.0 * t.counters.get("overflow_redos", 0) / chunks
