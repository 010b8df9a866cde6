"""The decode's bytes-bound work (MC, HZCC dequantization, the inverse
with its recon) at the published bandwidth, as a share of all kernel
time."""

from harness import readers


def read(t):
    return readers.roofline(t, "decode", ("mc", "hzcc_dequant", "inv_sbt"))
