"""The encode requests' host time outside every `gop.*` span of the
program (stream assembly, the stability chain's glue, the CLI's file
I/O) per encoded frame."""

from harness import readers


def read(t):
    return readers.unspanned_ms_per_frame(t, "encode")
