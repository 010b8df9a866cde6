"""The encode frame step's bytes-bound work (MC, Haar, the residual
prologue, the intra B4T, HZCC quantization, the inverse with its
recon) at the published bandwidth, as a share of all kernel time."""

from harness import readers


def read(t):
    return readers.roofline(t, "encode", ("mc", "haar", "residual_in",
                                          "b4t_fwd", "hzcc_quant", "inv_sbt"))
