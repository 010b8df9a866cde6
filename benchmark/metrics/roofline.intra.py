"""An intra-only frame's bytes-bound work (the residual prologue, the
intra B4T, the Haar levels, HZCC quantization; no MC and no inverse:
gop 0 reconstructs nothing) at the published bandwidth, as a share of
all kernel time."""

from harness import readers


def read(t):
    return readers.roofline(t, "encode", ("residual_in", "b4t_fwd", "haar",
                                          "hzcc_quant"))
