"""dsv1_tpu_torch — the DSV1 codec in PyTorch, with CUDA kernels for Hopper.

A port of the JAX package `dsv1_tpu` (which stays the reference): the
GOP-parallel encode with CRF, the reference's per-frame ABR law or
GOP-granular ABR, and intra-only CRF at gop 0 (`encode_stream_gops`),
several GOPs through each kernel launch (`gops_per_device`), with each
frame's quantized planes compacted on the device and each chunk of GOPs
packed natively, the GOP-sharded encode across processes
(`encode_stream_multihost`, `run_distributed_shard` on
torch.distributed), its decode twin
(`decode_stream_gops`, `iter_decode_gops`, several chains through each
launch), both over a device mesh (`gop_mesh`, `gop_tile_mesh`: GOPs
split over devices, each GOP's subband transforms in column tiles), the
column-tiled transforms themselves (`tile_mesh`, `fwd_sbt_tiled`,
`inv_sbt_tiled`, `encode_plane_tiled`), the sequential,
resumable `Encoder` and `Decoder` (with the `draw_info` overlay) and the
CLI (`python -m dsv1_tpu_torch.cli e|d`). Tensor work is PyTorch; the five
per-block or per-level kernels of these paths (motion-compensated
prediction, the coarse-level HME search, the level-0 HME search with the
luma intra cascade, which also serves the JAX package's banded 4K form,
and the forward Haar level) are CUDA C++ for sm_90a, built by nvcc at
first use (kernels/build.py). Every entry point runs on "cuda" unless
the caller passes device="cpu", where each kernel's plain PyTorch
version runs.

The port imports torch and never jax, and nothing of the JAX package:
it owns its copies of the jax-free modules it needs (constants,
models.metadata, models.bitstream, ops.golomb, bits with
native/dsvbits.cpp, utils.yuv, utils.bitrate, utils.chroma, and the
clip generators in utils.corpus).
"""

from .constants import (MAX_QUALITY, RATE_CONTROL_ABR, RATE_CONTROL_CRF,
                        SUBSAMP_411, SUBSAMP_420, SUBSAMP_422, SUBSAMP_444,
                        quality_percent)
from .models.metadata import Metadata

from .models.decoder import (DEC_EOS, DEC_ERROR, DEC_GOT_META, DEC_OK,
                             Decoder)
from .models.encoder import Encoder, EncoderConfig
from .parallel import (EncodedShard, Mesh, decode_stream_gops,
                       encode_plane_tiled, encode_shard, encode_stream_gops,
                       encode_stream_multihost, fwd_sbt_tiled, gop_mesh,
                       gop_tile_mesh, inv_sbt_tiled, iter_decode_gops,
                       join_tiles, mux_shards, run_distributed_shard,
                       shard_ranges, split_tiles, tile_mesh)
from .state import EncoderState, state_from_numpy

__all__ = ["SUBSAMP_444", "SUBSAMP_422", "SUBSAMP_420", "SUBSAMP_411",
           "MAX_QUALITY", "RATE_CONTROL_ABR", "RATE_CONTROL_CRF",
           "quality_percent", "Metadata", "EncoderConfig", "EncoderState",
           "state_from_numpy", "encode_stream_gops", "decode_stream_gops",
           "iter_decode_gops", "EncodedShard", "shard_ranges",
           "encode_shard", "mux_shards", "encode_stream_multihost",
           "run_distributed_shard", "Mesh", "gop_mesh", "gop_tile_mesh",
           "tile_mesh", "fwd_sbt_tiled", "inv_sbt_tiled",
           "encode_plane_tiled", "split_tiles", "join_tiles", "Encoder",
           "Decoder", "DEC_OK", "DEC_ERROR", "DEC_EOS", "DEC_GOT_META"]

__version__ = "0.1.0"
