"""Build and load the CUDA kernels (nvcc -> shared library -> ctypes).

At first use, one `nvcc -c` per `dsv1_tpu_torch/csrc/*.cu`, all started
together, compiles the sources, and one more links them into a shared
library with a plain C interface, under `build/torch_kernels/` of the
checkout, named by a hash of the sources (a changed source builds
anew). The library is loaded with ctypes: pointers and the stream go as
`c_void_p`, ints as `c_int`/`c_int64`. Each C entry point returns
`cudaGetLastError()` after its launch; `check()` raises if it is not 0.

Nothing here runs at import: the CPU tests import every module.
"""

import collections
import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

# launches per kernel: each wrapper adds one where it launches its kernel
LAUNCHES = collections.Counter()

_lib = None
BUILD_SECONDS = None


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _hashed():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    return str(cand) if cand.exists() else "nvcc"


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _hashed():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdsv1_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if this source hash has no library yet."""
    global BUILD_SECONDS
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o),
                               str(src)])
             for src, o in zip(_sources(), objs)]
    codes = [p.wait() for p in procs]
    if any(codes):
        raise RuntimeError(f"nvcc failed: exit codes {codes} for "
                           f"{[s.name for s in _sources()]}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp),
                    *[str(o) for o in objs]], check=True)
    os.replace(tmp, out)
    for o in objs:
        o.unlink()
    BUILD_SECONDS = time.perf_counter() - t0
    return out


def lib():
    """The loaded kernel library (built at first call)."""
    global _lib
    if _lib is None:
        L = ctypes.CDLL(str(build()))
        P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        L.dsv1_mc_frame.argtypes = [P, I64, P, I, I, P, P, P, P, P, P]
        L.dsv1_hme_refine.argtypes = [P, P, P, I64, I, I, I, I, I, I, I, I,
                                      I, I, I, I, P, P, P, P]
        L.dsv1_hme_base.argtypes = [P, P, P, I64, I, I, I, I, I, I, I, I,
                                    I, I, I, P, P, P, P, P, P, P]
        L.dsv1_haar_pyramid.argtypes = [P, I64, I, I, I, I, P, I64, P, P]
        for fn in (L.dsv1_mc_frame, L.dsv1_hme_refine, L.dsv1_hme_base,
                   L.dsv1_haar_pyramid):
            fn.restype = ctypes.c_int
        _lib = L
    return _lib


def check(err: int, name: str):
    """Raise if a launch reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def stream_ptr(t) -> int:
    """The current CUDA stream of tensor t's device, as an int."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
