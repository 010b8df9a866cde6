"""dsvintra: the plain reference that judges the intra-only encode (gop 0
under CRF), which the frozen reference dsvref does not copy.

Every frame is an intra, non-reference picture after its own metadata
packet (the JAX package's gop-0 branch of encode_stream_gops, its
`-gop0 -rc_mode1` CLI route): per frame, in turn, the prologue (the
planes less 128), this package's own forward transform (ops/sbt.py),
dsvref's plain quantizer with every block stable, a read of the dense
quantized planes, their (run, value) symbols (`runs_from_qvals`) and
dsvref's native picture packer, then EOS. It keeps no compacted planes,
no int8 transport and no chunk packer: it shares nothing with the
mechanism a gop-0 cell measures but the quantizer's arithmetic and the
entropy coder (dsvref's `native/dsvbits.cpp`). Every other encode, the
decode and the CLI's other routes are dsvref's. Nothing here imports
the program, the JAX package or JAX.
"""

from dsvref import (RATE_CONTROL_ABR, RATE_CONTROL_CRF, EncoderConfig,
                    Metadata, decode_stream_gops, quality_percent)

from .intra import encode_stream_gops

__all__ = ["RATE_CONTROL_ABR", "RATE_CONTROL_CRF", "quality_percent",
           "EncoderConfig", "Metadata", "encode_stream_gops",
           "decode_stream_gops"]
