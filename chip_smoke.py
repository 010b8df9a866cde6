#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits
non-zero:

1. device  — requires CUDA; prints the card's name and power limit.
2. build   — compiles dsv1_tpu_torch/csrc/*.cu with nvcc (sm_90a).
3. kernels — on a 1080p frame pair batch (one GOP's P frames), runs the
   three CUDA kernels and their plain PyTorch versions on the same
   inputs (pyramid planes, candidate MVs from the port's own coarse
   levels, an MC field from the port's HME), requires exact equality
   (tolerance 0: the codec is integer-only) and times both with CUDA
   events after warm-up. Then encodes and decodes two small clips with
   partial blocks and 4:4:4 chroma on the GPU and on the CPU (plain
   versions) and requires the same bytes.
4. slice   — encodes the CIF and 1080p golden clips (gop 12, qp 85 CRF,
   24 frames) on the GPU and decodes the streams; the stream and the
   decoded planes must hash to dsv1_tpu_torch/data/golden.json, which
   the JAX package produced (tools/torch_golden.py). Every kernel's
   launch count over this phase must be > 0.

The last line is {"ok": true, "device": {...}}.
"""

import os
import sys

# dsv1_tpu/__init__.py imports jax whenever JAX_PLATFORMS is set, and the
# port reuses jax-free modules of that package: drop the variable before
# the first import so this run never loads jax.
os.environ.pop("JAX_PLATFORMS", None)

import hashlib  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent
ENCODE_REPS = 2   # the first encode/decode of a clip includes warm-up


def emit(obj):
    print(json.dumps(obj), flush=True)


def sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def max_abs_err(a, b) -> int:
    """Largest |a - b| over tensors (or tuples of tensors) of equal
    shapes."""
    import torch
    if isinstance(a, (tuple, list)):
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    if a.shape != b.shape:
        raise AssertionError(f"shape mismatch {tuple(a.shape)} vs "
                             f"{tuple(b.shape)}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def phase_device():
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvidia_smi": smi})
    return smi


def phase_build():
    from dsv1_tpu_torch.kernels import build as kb
    t0 = time.perf_counter()
    path = kb.build()
    kb.lib()
    emit({"phase": "build", "library": str(path.relative_to(ROOT)),
          "nvcc_seconds": kb.BUILD_SECONDS,
          "seconds": time.perf_counter() - t0})


def golden_clip(name):
    from tools.torch_golden import clip_frames
    return clip_frames(name)


def phase_kernels(dev):
    """Each kernel vs its plain version at the 1080p main-path shapes, on
    the arguments the main path itself passes to the kernel."""
    import numpy as np
    import torch

    import dsv1_tpu_torch as dt
    from dsv1_tpu_torch.ops import bmc, hme_kernels as hk, mc
    from dsv1_tpu_torch.parallel.gop import build_gop_encoder
    from tools.torch_golden import GOP as G, QUALITY_PCT

    _yuv, frames = golden_clip("1080p")
    enc = build_gop_encoder(dt.SUBSAMP_420, 1920, 1080, G,
                            dt.quality_percent(QUALITY_PCT), True, 4, 50,
                            G - 1, 0, str(dev))
    packed = torch.from_numpy(np.stack([
        np.concatenate([np.asarray(p, np.uint8).ravel() for p in f])
        for f in frames[:G]])).to(dev)
    calls = []
    imgs, _al, mv, _has_ref = enc.motion(packed, calls=calls)
    lvl_args = [a for name, a in calls if name == "hme_refine"]
    (bargs,) = [a for name, a in calls if name == "hme_base"]
    B = bargs[0].shape[0]
    bw, bh, nbh, nbv = enc.blk_w, enc.blk_h, enc.nbh, enc.nbv
    rows = []

    # --- coarse levels: kernel vs plain at every level, same inputs
    err = max(max_abs_err(hk.refine_level(*a), hk.refine_level_plain(*a))
              for a in lvl_args)
    ms = cuda_ms(lambda: [hk.refine_level(*a) for a in lvl_args], 20)
    plain_ms = cuda_ms(lambda: [hk.refine_level_plain(*a)
                                for a in lvl_args], 3)
    rows.append({"name": "hme_refine", "route": "cuda",
                 "source": "dsv1_tpu_torch/csrc/hme.cu",
                 "replaces": "dsv1_tpu/ops/pallas_hme.py:130",
                 "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                 "shape": f"levels {enc.levels}..1, B={B}"})

    # --- level 0
    err = max_abs_err(hk.refine_base(*bargs), hk.refine_base_plain(*bargs))
    ms = cuda_ms(lambda: hk.refine_base(*bargs), 20)
    plain_ms = cuda_ms(lambda: hk.refine_base_plain(*bargs), 3)
    rows.append({"name": "hme_base", "route": "cuda",
                 "source": "dsv1_tpu_torch/csrc/hme.cu",
                 "replaces": "dsv1_tpu/ops/pallas_hme.py:339",
                 "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                 "shape": f"B={B} nb={nbh * nbv} {bw}x{bh}"})

    # --- MC on every plane of the P frame with the most intra blocks,
    # with its HME field; then the same shapes under a fuzzed field
    # (random modes and submasks, MVs far past the plane edges)
    lay = enc.layouts[0]
    k = int(mv["nintra"].argmax())
    gen = torch.Generator().manual_seed(11)

    def fuzz(hi, lo=0):
        return torch.randint(lo, hi, (nbv, nbh), generator=gen,
                             dtype=torch.int32).to(dev)

    fields = [(mv["mode"][k], mv["mvx"][k], mv["mvy"][k], mv["submask"][k]),
              (fuzz(2), fuzz(4 * 1920, -4 * 1920), fuzz(4 * 1080, -4 * 1080),
               fuzz(16))]
    err, ms, plain_ms = 0, 0.0, 0.0
    for fi, (mode, mvx, mvy, sub) in enumerate(fields):
        for c in range(3):
            margs = bmc.mc_args(imgs[0][k], lay, c, bw, bh, nbh, nbv, mode,
                                mvx, mvy, sub)
            err = max(err, max_abs_err(mc.predict(*margs),
                                       mc.predict_plain(*margs)))
            if fi == 0:
                ms += cuda_ms(lambda: mc.predict(*margs), 50)
                plain_ms += cuda_ms(lambda: mc.predict_plain(*margs), 5)
    rows.append({"name": "mc", "route": "cuda",
                 "source": "dsv1_tpu_torch/csrc/mc.cu",
                 "replaces": "dsv1_tpu/ops/pallas_mc.py:38",
                 "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                 "shape": "one 1080p frame, 3 planes",
                 "intra_blocks": int(mv["nintra"][k])})
    for r in rows:
        emit({"phase": "kernels", **r})
        if r["max_abs_err"] != 0:
            raise AssertionError(f"kernel {r['name']} disagrees with its "
                                 f"plain version")
    return rows


def phase_edges(dev):
    """The whole encode + decode on the GPU (kernels) and on the CPU
    (plain versions) must give the same bytes at geometries the golden
    clips do not reach: partial right and bottom blocks, 4:4:4 chroma."""
    import dsv1_tpu_torch as dt
    from tests import corpus
    from tools.torch_golden import split_frames

    for w, h, subsamp in ((100, 84, dt.SUBSAMP_420), (96, 80, dt.SUBSAMP_444)):
        frames = split_frames(corpus.make_clip(w, h, subsamp, 8, seed=5),
                              w, h, subsamp, 8)
        meta = dt.Metadata(w, h, subsamp)
        cfg = dt.EncoderConfig(gop=4, stable_refresh=3)
        gpu = dt.encode_stream_gops(frames, meta, cfg, device=dev)
        cpu = dt.encode_stream_gops(frames, meta, cfg, device="cpu")
        dg = dt.decode_stream_gops(gpu, device=dev)[1]
        dc = dt.decode_stream_gops(gpu, device="cpu")[1]
        same_dec = len(dg) == len(dc) == len(frames) and all(
            (a == b).all() for (_, pa), (_, pb) in zip(dg, dc)
            for a, b in zip(pa, pb))
        emit({"phase": "edges", "size": f"{w}x{h}", "subsamp": subsamp,
              "stream_equal": gpu == cpu, "decode_equal": bool(same_dec)})
        if gpu != cpu or not same_dec:
            raise AssertionError(f"{w}x{h}: GPU and CPU paths disagree")


def phase_slice(dev, smi):
    """The main path: encode + decode both golden clips on the GPU."""
    import torch

    import dsv1_tpu_torch as dt
    from dsv1_tpu_torch.kernels.build import LAUNCHES
    from tools.torch_golden import GOP, QUALITY_PCT, decoded_bytes

    golden = json.loads((ROOT / "dsv1_tpu_torch" / "data" / "golden.json")
                        .read_text())
    clips = {name: golden_clip(name) for name in ("cif", "1080p")}
    LAUNCHES.clear()
    results = []
    for name in ("cif", "1080p"):
        gold = golden[name]
        yuv, frames = clips[name]
        if sha(yuv) != gold["clip_sha256"]:
            raise AssertionError(f"{name}: input clip differs from the "
                                 "golden clip")
        meta = dt.Metadata(gold["width"], gold["height"], dt.SUBSAMP_420)
        cfg = dt.EncoderConfig(quality=dt.quality_percent(QUALITY_PCT),
                               gop=GOP, stable_refresh=GOP - 1)
        for rep in range(ENCODE_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stream = dt.encode_stream_gops(frames, meta, cfg, device=dev)
            t_enc = time.perf_counter() - t0
            if sha(stream) != gold["stream_sha256"]:
                raise AssertionError(f"{name}: stream differs from golden")
            t0 = time.perf_counter()
            _m, dec = dt.decode_stream_gops(stream, device=dev)
            t_dec = time.perf_counter() - t0
            if sha(decoded_bytes(dec)) != gold["decode_sha256"]:
                raise AssertionError(f"{name}: decode differs from golden")
        n = len(frames)
        results.append({"phase": "slice", "clip": name,
                        "size": f"{gold['width']}x{gold['height']}",
                        "frames": n, "stream_bytes": len(stream),
                        "stream_sha256_ok": True, "decode_sha256_ok": True,
                        "encode_fps": n / t_enc, "decode_fps": n / t_dec,
                        "card": smi})
    launches = dict(LAUNCHES)
    for r in results:
        emit(r)
    emit({"phase": "slice", "launches": launches})
    for k in ("mc", "hme_refine", "hme_base"):
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"kernel {k} was not launched on the "
                                 "main path")
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    # fail before printing anything when the port is not beside this file
    sys.path.insert(0, str(ROOT))
    import dsv1_tpu_torch  # noqa: F401
    smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    rows = phase_kernels(dev)
    phase_edges(dev)
    launches = phase_slice(dev, smi)
    for r in rows:
        r["launches"] = launches[r["name"]]
    emit({"kernels": [{k: r[k] for k in ("name", "route", "source",
                                         "replaces", "launches",
                                         "max_abs_err", "ms", "plain_ms")}
                      for r in rows]})
    if "jax" in sys.modules:
        raise AssertionError("the port's run loaded jax")
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
