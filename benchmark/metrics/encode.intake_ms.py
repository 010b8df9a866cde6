"""The frame intake of encode chunks (`encode.intake` spans: pulling a
chunk's frames, the CLI's disk reads among them, packing and stacking
them) per encoded frame."""

from harness import hostspans


def read(t):
    return hostspans.spans_ms_per_frame(t, "encode", "encode.intake")
