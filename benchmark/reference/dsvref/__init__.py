"""dsvref: a frozen copy of dsv1_tpu_torch's plain path, the benchmark's
reference encoder and decoder.

Copied from the port when its first benchmark was written, while the
port was byte-identical to the JAX package on every golden clip and in
the tier-1 tests, and cut to what the benchmark's checks run: the
GOP-parallel encode on one device (CRF, and the per-frame ABR of the
CLI's encode at its defaults) and the GOP-parallel decode. What was
taken out: the CUDA kernels and their wrappers' kernel branches (every
op runs its plain PyTorch version, on whatever device its tensors are
on), the kernel build, meshes and column tiles, the sharded encode, the
sequential encoder and decoder, gop 0, GOP-granular ABR, the CLI's
decode, the golden clips and the clip generators. The entropy stage is
the copy's own `native/dsvbits.cpp`, as in the JAX package and the port:
the repository has no plain form of it. Nothing here imports the port,
the JAX package or JAX; later changes to the port are held to what this
copy computes. benchmark/tests/test_bench_golden.py holds it to the JAX
package's golden hashes.
"""

from .constants import RATE_CONTROL_ABR, RATE_CONTROL_CRF, quality_percent
from .models.encoder import EncoderConfig
from .models.metadata import Metadata
from .parallel import decode_stream_gops, encode_stream_gops

__all__ = ["RATE_CONTROL_ABR", "RATE_CONTROL_CRF", "quality_percent",
           "EncoderConfig", "Metadata", "encode_stream_gops",
           "decode_stream_gops"]
