"""Percent of the slice's chunks of GOPs whose P planes overflowed their
cap of (run, value) pairs (the program's `overflow_p` over its
`chunks`); `overflow_share` counts either cap."""

from harness import hostspans


def read(t):
    return hostspans.counter_share(t, "encode", "overflow_p", "chunks")
