"""Device kernels (copies and sets left out) per decoded frame."""

from harness import readers


def read(t):
    return readers.kernels_per_frame(t, "decode")
