"""GOP-parallel encode and decode on one device, and the GOP-sharded
encode across processes (multihost)."""

from .decode import build_gop_decoder, decode_stream_gops, iter_decode_gops
from .gop import build_gop_encoder, encode_stream_gops
from .multihost import (EncodedShard, encode_shard, encode_stream_multihost,
                        mux_shards, run_distributed_shard, shard_ranges)

__all__ = ["EncodedShard", "build_gop_decoder", "build_gop_encoder",
           "decode_stream_gops", "encode_shard", "encode_stream_gops",
           "encode_stream_multihost", "iter_decode_gops", "mux_shards",
           "run_distributed_shard", "shard_ranges"]
