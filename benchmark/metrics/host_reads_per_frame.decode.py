"""The decode's blocking host reads (the program's `host_reads`) per
decoded frame."""

from harness import hostspans


def read(t):
    return hostspans.counter_per_frame(t, "decode", "host_reads")
