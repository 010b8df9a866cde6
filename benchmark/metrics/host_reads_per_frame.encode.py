"""The encode's blocking host reads (the program's `host_reads`: copies
and per-frame ABR quality reads) per encoded frame."""

from harness import hostspans


def read(t):
    return hostspans.counter_per_frame(t, "encode", "host_reads")
