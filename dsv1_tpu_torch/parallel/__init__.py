"""GOP-parallel encode and decode on one device or over a device mesh
(GOP meshes, gop x tile meshes, subband column tiles), and the
GOP-sharded encode across processes (multihost)."""

from .decode import build_gop_decoder, decode_stream_gops, iter_decode_gops
from .gop import build_gop_encoder, encode_stream_gops
from .mesh import Mesh, gop_mesh, gop_tile_mesh, tile_mesh
from .multihost import (EncodedShard, encode_shard, encode_stream_multihost,
                        mux_shards, run_distributed_shard, shard_ranges)
from .tile import (encode_plane_tiled, fwd_sbt_tiled, inv_sbt_tiled,
                   join_tiles, split_tiles)

__all__ = ["EncodedShard", "Mesh", "build_gop_decoder", "build_gop_encoder",
           "decode_stream_gops", "encode_plane_tiled", "encode_shard",
           "encode_stream_gops", "encode_stream_multihost", "fwd_sbt_tiled",
           "gop_mesh", "gop_tile_mesh", "inv_sbt_tiled", "iter_decode_gops",
           "join_tiles", "mux_shards", "run_distributed_shard",
           "shard_ranges", "split_tiles", "tile_mesh"]
