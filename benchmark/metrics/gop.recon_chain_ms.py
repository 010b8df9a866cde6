"""The host time of the chunks' recon chains (`gop.recon_chain` spans, less
the `gop.rate_read` spans inside them) per encoded frame."""

from harness import readers


def read(t):
    return readers.span_ms_per_frame(t, "encode", "gop.recon_chain",
                                     less="gop.rate_read")
