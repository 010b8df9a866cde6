"""The blocking device-to-host reads of encode chunks (`encode.read`
spans: the motion verdicts, the compacted planes, the dense planes on
overflow) per encoded frame."""

from harness import hostspans


def read(t):
    return hostspans.spans_ms_per_frame(t, "encode", "encode.read")
