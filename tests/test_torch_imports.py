"""The port never imports jax or the JAX package, runs on the card unless
asked for the CPU, and never runs on the CPU when CUDA is asked for."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import dsv1_tpu_torch as dt
from dsv1_tpu_torch import cli
from dsv1_tpu_torch.kernels.build import LAUNCHES
from dsv1_tpu_torch.parallel import (build_gop_decoder, build_gop_encoder,
                                     iter_decode_gops)

from . import corpus

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

SCRIPT = """
import sys, tempfile
from pathlib import Path
import numpy as np
import torch
torch.set_num_threads(1)
import dsv1_tpu_torch as dt
from dsv1_tpu_torch import cli
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
from dsv1_tpu_torch.parallel import multihost
mh = multihost.encode_stream_multihost(
    frames * 3, dt.Metadata(w, h, dt.SUBSAMP_420),
    dt.EncoderConfig(gop=3, stable_refresh=2), n_shards=2, device="cpu")
assert mh == dt.encode_stream_gops(
    frames * 3, dt.Metadata(w, h, dt.SUBSAMP_420),
    dt.EncoderConfig(gop=3, stable_refresh=2), device="cpu")
ms = dt.encode_stream_gops(frames * 3, dt.Metadata(w, h, dt.SUBSAMP_420),
                           dt.EncoderConfig(gop=3, stable_refresh=2),
                           mesh=dt.gop_mesh(["cpu"] * 2))
assert ms == mh
assert len(dt.decode_stream_gops(ms, mesh=dt.gop_mesh(["cpu"] * 2))[1]) == 9
assert dt.encode_stream_gops(frames * 3, dt.Metadata(w, h, dt.SUBSAMP_420),
                             dt.EncoderConfig(gop=3, stable_refresh=2),
                             mesh=dt.gop_tile_mesh(1, 2, ["cpu"] * 2)) == mh
tm = dt.tile_mesh(["cpu"] * 2)
a = torch.arange(32 * 48, dtype=torch.int32).reshape(32, 48) % 97 - 48
t = dt.fwd_sbt_tiled(dt.split_tiles(a, tm), False, tm)
r = dt.join_tiles(dt.inv_sbt_tiled(t, 200, False, True, tm))
assert r.shape == a.shape
enc = dt.Encoder(dt.Metadata(w, h, dt.SUBSAMP_420),
                 dt.EncoderConfig(gop=3, stable_refresh=2), device="cpu")
enc.start()
seq = enc.encode_stream(frames)
assert len(list(dt.Decoder(draw_info=7, device="cpu").decode_stream(seq))) == 3
with tempfile.TemporaryDirectory() as td:
    yuv = Path(td) / "in.yuv"
    yuv.write_bytes(b"".join(p.tobytes() for f in frames for p in f))
    args = [f"-inp_{yuv}", f"-w{w}", f"-h{h}", "-y"]
    assert cli.main(["e", *args, f"-out_{td}/s.dsv"], device="cpu") == 0
    assert cli.main(["d", f"-inp_{td}/s.dsv", f"-out_{td}/o.yuv"],
                    device="cpu") == 0
    assert Path(td, "o.yuv").stat().st_size == yuv.stat().st_size
bad = sorted(m for m in sys.modules if m.startswith(("jax", "dsv1_tpu"))
             and m.split(".")[0] != "dsv1_tpu_torch")
assert not bad, bad
print("OK", len(s))
"""


def test_port_never_imports_jax():
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    r = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.startswith("OK")


IMPORT_OF_JAX_PACKAGE = re.compile(
    r"^\s*(from\s+dsv1_tpu(?!_torch)\b|import\s+dsv1_tpu(?!_torch)\b"
    r"|from\s+jax\b|import\s+jax\b)", re.M)


def test_no_source_imports_the_jax_package():
    files = sorted((ROOT / "dsv1_tpu_torch").rglob("*.py"))
    # chip_smoke.py and the tools it runs
    files += [ROOT / "chip_smoke.py", ROOT / "tools" / "torch_profile.py",
              ROOT / "tools" / "torch_shard_worker.py",
              ROOT / "tools" / "torch_mesh_cards.py"]
    assert len(files) > 20
    bad = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
           for f in files for m in IMPORT_OF_JAX_PACKAGE.finditer(
               f.read_text())]
    assert not bad, bad


def test_cpu_tensors_take_the_plain_versions():
    frames = corpus.make_clip_frames(48, 32, dt.SUBSAMP_420, 3, seed=2)
    LAUNCHES.clear()
    dt.encode_stream_gops(frames, dt.Metadata(48, 32, dt.SUBSAMP_420),
                          dt.EncoderConfig(gop=3, stable_refresh=2),
                          device="cpu")
    assert sum(LAUNCHES.values()) == 0


def test_cuda_request_raises_without_cuda():
    """Without a device every entry point asks for the card, which this
    machine lacks: each raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    frames = corpus.make_clip_frames(48, 32, dt.SUBSAMP_420, 2, seed=2)
    meta = dt.Metadata(48, 32, dt.SUBSAMP_420)
    calls = [
        lambda: dt.encode_stream_gops(frames, meta, dt.EncoderConfig(gop=2)),
        lambda: dt.decode_stream_gops(b""),
        lambda: next(iter_decode_gops(b"")),
        lambda: build_gop_encoder(dt.SUBSAMP_420, 48, 32, 2, 1),
        lambda: build_gop_decoder(dt.SUBSAMP_420, 48, 32, 16, 16),
        lambda: dt.Encoder(meta),
        lambda: dt.Decoder(),
        lambda: dt.encode_stream_gops(frames, meta, dt.EncoderConfig(gop=2),
                                      device="cuda"),
        lambda: dt.encode_stream_multihost(frames, meta,
                                           dt.EncoderConfig(gop=2)),
        lambda: dt.encode_shard(frames, meta, dt.EncoderConfig(gop=2), 0),
        lambda: dt.run_distributed_shard("127.0.0.1:1", 1, 0, frames, meta,
                                         dt.EncoderConfig(gop=2)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_meshes_raise_without_cuda():
    """A mesh of every visible CUDA device, or of CUDA entries, raises
    where there is no card: no CPU pick."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default devices are valid")
    for call in (dt.gop_mesh, dt.tile_mesh,
                 lambda: dt.gop_tile_mesh(1, 1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    for call in (lambda: dt.gop_mesh(["cuda:0"] * 2),
                 lambda: dt.tile_mesh(["cuda:0"]),
                 lambda: dt.gop_tile_mesh(2, 2, ["cuda:0"] * 4)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_cli_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    (tmp_path / "in.yuv").write_bytes(
        corpus.make_clip(48, 32, dt.SUBSAMP_420, 2, seed=1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["e", f"-inp_{tmp_path}/in.yuv", f"-out_{tmp_path}/s.dsv",
                  "-w48", "-h32", "-y"])
