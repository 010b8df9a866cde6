"""The port never imports jax, and never runs on the CPU when CUDA is
asked for."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import dsv1_tpu_torch as dt
from dsv1_tpu_torch.device import resolve
from dsv1_tpu_torch.kernels.build import LAUNCHES

from . import corpus

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

SCRIPT = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)
import dsv1_tpu_torch as dt
w, h = 48, 32
rng = np.random.default_rng(0)
frames = [(rng.integers(0, 256, (h, w), dtype=np.uint8),
           rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8),
           rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8))
          for _ in range(3)]
s = dt.encode_stream_gops(frames, dt.Metadata(w, h, dt.SUBSAMP_420),
                          dt.EncoderConfig(gop=3, stable_refresh=2),
                          device="cpu")
meta, dec = dt.decode_stream_gops(s, device="cpu")
assert len(dec) == 3
assert "jax" not in sys.modules, "the port imported jax"
print("OK", len(s))
"""


def test_port_never_imports_jax():
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    r = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.startswith("OK")


def test_cpu_tensors_take_the_plain_versions():
    frames = corpus.make_clip_frames(48, 32, dt.SUBSAMP_420, 3, seed=2)
    LAUNCHES.clear()
    dt.encode_stream_gops(frames, dt.Metadata(48, 32, dt.SUBSAMP_420),
                          dt.EncoderConfig(gop=3, stable_refresh=2),
                          device="cpu")
    assert sum(LAUNCHES.values()) == 0


def test_cuda_request_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the request is valid here")
    frames = corpus.make_clip_frames(48, 32, dt.SUBSAMP_420, 2, seed=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dt.encode_stream_gops(frames, dt.Metadata(48, 32, dt.SUBSAMP_420),
                              dt.EncoderConfig(gop=2), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dt.decode_stream_gops(b"", device="cuda")
    with pytest.raises(ValueError):
        resolve(None)
