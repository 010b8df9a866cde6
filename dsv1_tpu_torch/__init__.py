"""dsv1_tpu_torch — the DSV1 codec in PyTorch, with CUDA kernels for Hopper.

A port of the JAX package `dsv1_tpu` (which stays the reference): the
GOP-parallel CRF encode and its decode twin. Tensor work is PyTorch; the
three per-block kernels of the main path (motion-compensated prediction,
the coarse-level HME search and the level-0 HME search with the luma
intra cascade) are CUDA C++ for sm_90a, built by nvcc at first use
(kernels/build.py). Every entry point takes an explicit `device`: on
"cuda" the kernels run, on "cpu" their plain PyTorch versions do.

The port imports torch and never jax. From the JAX package it reuses
only the modules that never import jax: constants, models.metadata,
models.bitstream, ops.golomb, bits (native packing) and utils.yuv.
"""

from dsv1_tpu.constants import (MAX_QUALITY, SUBSAMP_411, SUBSAMP_420,
                                SUBSAMP_422, SUBSAMP_444, quality_percent)
from dsv1_tpu.models.metadata import Metadata

from .models.encoder import EncoderConfig
from .parallel import decode_stream_gops, encode_stream_gops
from .state import EncoderState, state_from_numpy

__all__ = ["SUBSAMP_444", "SUBSAMP_422", "SUBSAMP_420", "SUBSAMP_411",
           "MAX_QUALITY", "quality_percent", "Metadata", "EncoderConfig",
           "EncoderState", "state_from_numpy", "encode_stream_gops",
           "decode_stream_gops"]

__version__ = "0.1.0"
