"""Megabytes (1e6 bytes) read device-to-host by the encode's blocking
reads (the program's `d2h_bytes`) per encoded frame."""

from harness import hostspans


def read(t):
    return hostspans.counter_per_frame(t, "encode", "d2h_bytes", 1e-6)
