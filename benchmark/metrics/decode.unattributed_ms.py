"""The decode requests' host time under no span of the program per decoded
frame: what the program's spans leave unnamed."""

from harness import hostspans


def read(t):
    return hostspans.unattributed_ms_per_frame(t, "decode")
