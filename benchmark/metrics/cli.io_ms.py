"""The CLI's file I/O (`cli.read` spans of input frames and `cli.write`
spans of the output file) per encoded frame."""

from harness import hostspans


def read(t):
    return hostspans.spans_ms_per_frame(t, "encode", "cli.read", "cli.write")
