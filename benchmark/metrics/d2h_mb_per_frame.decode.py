"""Megabytes (1e6 bytes) read device-to-host by the decode's blocking
reads (the program's `d2h_bytes`) per decoded frame."""

from harness import hostspans


def read(t):
    return hostspans.counter_per_frame(t, "decode", "d2h_bytes", 1e-6)
