#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits
non-zero:

1. device  — requires CUDA; prints the card's name, power limit and
   maximum SM clock (the integer peak of the bounds below).
2. build   — compiles dsv1_tpu_torch/csrc/*.cu with nvcc (sm_90a), one
   process per source, all started together.
3. kernels — each CUDA kernel against its plain PyTorch version on the
   same inputs, at the main path's shapes: on a 1080p GOP (one GOP's 11
   P-frame pairs; the arguments `hme_batch` itself passes) `hme_refine`
   and `hme_base`; `mc` (`bmc.compensate_frame`, one call per frame, all
   three planes) on a P frame's HME field and on a fuzzed field; on a
   3840x2160 GOP `hme_base` again (the work of the JAX package's banded
   4K kernel) and `mc` on both fields; `haar_fwd`
   (`sbt.haar_fwd_pyramid`, one call per plane, every Haar level) on a
   1080p luma P plane and I plane, a 4K luma P plane and a few odd
   shapes. Equality is exact (tolerance 0: the codec is integer-only).
   Both are timed with CUDA events after warm-up, wrappers included;
   the redesigned `mc` and `haar_fwd` also with torch.profiler's kernel
   sums (device only). Each row gets the least time the card could take
   for the same work (bytes over 3.35 TB/s, integer operations over 132
   SMs x 64 INT32 lanes x the SM clock, the larger of the two).
4. edges   — small clips with partial blocks, 4:4:4 chroma and per-frame
   ABR, encoded and decoded on the GPU and on the CPU (plain versions):
   the same bytes.
5. slice   — the CIF and 1080p golden clips (gop 12, qp 85 CRF, 24
   frames) through `encode_stream_gops` and `decode_stream_gops`.
6. cli     — the CLI's default path (per-frame ABR, auto bitrate, gop
   12): `dsv1_tpu_torch.cli.main` e then d on the CIF clip (24 frames)
   and on a 3840x2160 clip (13 frames), through files.
Phases 5 and 6 are main paths: each path's streams and decodes must
hash to dsv1_tpu_torch/data/golden.json (written from the JAX package
by tools/torch_golden.py), and the kernels' launch counts are set to 0
before each path and read after it; every kernel must have launched on
each path.

The line before the card's line lists every kernel with its launches,
error and times; the last line is {"ok": true, "device": {...}}.
"""

import hashlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ENCODE_REPS = 2            # the first encode/decode of a clip warms up
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
INT32_LANES = 132 * 64     # SMs x INT32 lanes per SM
KERNELS = ("mc", "hme_refine", "hme_base", "haar_fwd")
SLICE_CLIPS = ("cif", "1080p")     # encode_stream_gops, CRF
CLI_CLIPS = ("cif_cli", "4k_cli")  # the CLI at its defaults (ABR)
ROW_KEYS = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")


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


def smi_query(fields: str, units: bool = True) -> str:
    fmt = "csv,noheader" + ("" if units else ",nounits")
    return subprocess.run(["nvidia-smi", f"--query-gpu={fields}",
                           f"--format={fmt}"], capture_output=True,
                          text=True, check=True).stdout.strip() \
        .splitlines()[0]


def phase_device():
    import torch
    smi = smi_query("name,power.limit")
    clock_mhz = float(smi_query("clocks.max.sm", units=False))
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvidia_smi": smi,
          "max_sm_clock_mhz": clock_mhz})
    return smi, clock_mhz * 1e6


def phase_build():
    from dsv1_tpu_torch.kernels import build as kb
    t0 = time.perf_counter()
    path = kb.build()
    kb.lib()
    emit({"phase": "build", "library": str(path.relative_to(ROOT)),
          "nvcc_seconds": kb.BUILD_SECONDS,
          "seconds": time.perf_counter() - t0})


class Bound:
    """The least time the card could take for a kernel's work: its bytes
    (each input read once, each output written once) over the HBM rate,
    or its integer operations over the INT32 peak, whichever is larger."""

    def __init__(self, clock_hz: float):
        self.ops_per_s = INT32_LANES * clock_hz

    def __call__(self, nbytes: float, ops: float):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / self.ops_per_s * 1e3
        return (max(t_bytes, t_ops),
                "bytes" if t_bytes >= t_ops else "operations")


def _search_area(w, h, nbh_l, nb, BW, BH):
    """Pixels inside the frame over all blocks of a level."""
    return min(nbh_l * BW, w) * min((nb // nbh_l) * BH, h)


def work_hme_refine(args):
    """(bytes, ops) of one coarse-level call: both planes, candidates
    and outputs; per block pixel 3 ops (sub, abs, add) for each of NC
    candidates and 9 refine points."""
    src2d, _ref, cmx, _cmy, _E, w, h, nbh_l, nb, BW, BH, _lvl = args
    B, NC = src2d.shape[0], cmx.shape[-1]
    nbytes = 2 * src2d.numel() + B * nb * (2 * NC + 3) * 4
    return nbytes, B * _search_area(w, h, nbh_l, nb, BW, BH) * 3 * (NC + 9)


def work_hme_base(args):
    """(bytes, ops) of one level-0 call: as hme_refine, plus 28 ops per
    block pixel for its statistics (sums, squares, gradients, zero-MV
    window, intra test, quadrant metric) and, per in-frame block, 10 ops
    per pixel of the 14x14 centre for each of the 8 half-pel points and
    20 for the two texture statistics."""
    src2d, _ref, cmx, _cmy, _E, w, h, nbh_l, nb, BW, BH = args
    B, NC = src2d.shape[0], cmx.shape[-1]
    nbv_l = nb // nbh_l
    inframe = min(nbh_l, -(-w // BW)) * min(nbv_l, -(-h // BH))
    nbytes = 2 * src2d.numel() + B * nb * (2 * NC + 6) * 4
    ops = B * (_search_area(w, h, nbh_l, nb, BW, BH) * (3 * (NC + 9) + 28)
               + inframe * 14 * 14 * (8 * 10 + 20))
    return nbytes, ops


def work_mc(planes, nbh, nbv, fields):
    """(bytes, ops) of one frame's prediction with this field: per inter
    block the neighbourhood its phase reads (luma 3 more rows for a
    vertical half-pel, 3 more columns for a horizontal one; chroma one
    more of each), per intra block its zero-MV window, every pixel
    written once, 16 B of fields per block. Ops per pixel: 8 for a luma
    vertical or horizontal half-pel, 30 for the luma diagonal (four
    horizontal 4-taps and a vertical one), 4 and 6 for chroma, 0 for a
    full-pel copy, 4 for an intra pixel (sum, quadrant, divide)."""
    import numpy as np

    from dsv1_tpu_torch.constants import MODE_INTER
    modes, mvx, mvy, _ = (f.reshape(-1).cpu().numpy().astype(np.int64)
                          for f in fields)
    inter = modes == MODE_INTER
    nbytes, ops = 16 * modes.size, 0
    for c, g in enumerate(planes):
        bw_c = np.clip(g.w - np.tile(np.arange(nbh) * g.BW, nbv), 0, g.BW)
        bh_c = np.clip(g.h - np.repeat(np.arange(nbv) * g.BH, nbh), 0, g.BH)
        px = bw_c * bh_c
        xh, yh = (mvx >> g.sh) & 1, (mvy >> g.sv) & 1
        k = 3 if c == 0 else 1
        nb = (bh_c + k * yh) * (bw_c + k * xh)
        nbytes += int(np.where(inter, nb, px).sum() + px.sum())
        per = np.where(xh & yh, 30 if c == 0 else 6,
                       np.where(xh | yh, 8 if c == 0 else 4, 0))
        ops += int((np.where(inter, per, 4) * px).sum())
    return nbytes, ops


def work_haar(hs, ws):
    """(bytes, ops) of a Haar pyramid on a (hs, ws) region: each int32
    of the region read once, each band value and the last LL written
    once (as many values as the region has); 8 adds and the LL scale
    per 2x2 quad, about 3 ops per pixel at the first level and a third
    more for the levels below it."""
    return 8 * hs * ws, 4 * hs * ws


def row(name, source, replaces, err, ms, plain_ms, work, bound, **extra):
    b_ms, b_by = bound(*work)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, **extra}


def gop_motion(dev, frames):
    """A GOP's motion through the port's encoder; returns (encoder,
    images, motion dict, the HME kernels' calls)."""
    import numpy as np
    import torch

    import dsv1_tpu_torch as dt
    from dsv1_tpu_torch.parallel.gop import build_gop_encoder
    from dsv1_tpu_torch.utils.golden import GOP as G, QUALITY_PCT

    h, w = frames[0][0].shape
    enc = build_gop_encoder(dt.SUBSAMP_420, w, h, G,
                            dt.quality_percent(QUALITY_PCT), True, 4, 50,
                            G - 1, 0, str(dev))
    packed = torch.from_numpy(np.stack([
        np.concatenate([np.asarray(p, np.uint8).ravel() for p in f])
        for f in frames[:G]])).to(dev)
    calls = []
    imgs, _al, mv, _has_ref = enc.motion(packed, calls=calls)
    return enc, imgs, mv, calls


def device_ms(fn, reps: int) -> float:
    """Device time of fn() per call: torch.profiler's kernel sums over
    reps calls (memcpy and memset left out), after one warm-up."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and not e.key.startswith(("Memcpy", "Memset")))
    return us * 1e-3 / reps


def haar_case(dev, hs, ws, is_p, seed):
    """The arguments fwd_sbt gives haar_fwd_pyramid for a (hs, ws) plane
    of random centred coefficients: (region, out, first, lvls); for an
    I plane out holds the B4T level and the region is a copy of its LL."""
    import numpy as np
    import torch
    from dsv1_tpu_torch.ops import sbt
    a = np.random.default_rng(seed).integers(-255, 256, (hs, ws))
    coefs = torch.from_numpy(a.astype(np.int32)).to(dev)
    lvls = sbt.nlevels(ws, hs)
    if is_p:   # out starts as a sentinel no band value can take
        return coefs, torch.full_like(coefs, -2**31), 1, lvls
    out = sbt._b4t_fwd_2d(coefs)
    return out[:(hs + 1) // 2, :(ws + 1) // 2].clone(), out, 2, lvls


def check_haar(dev, hs, ws, is_p, seed, timed=True):
    """haar_fwd_pyramid on one plane, kernel vs plain: (max_abs_err,
    kernel ms, plain ms, kernel device ms, (bytes, ops))."""
    from dsv1_tpu_torch.ops import sbt
    cur, out, first, lvls = haar_case(dev, hs, ws, is_p, seed)
    out_k, out_p = out.clone(), out.clone()
    sbt.haar_fwd_pyramid(cur, out_k, first, lvls)
    sbt._haar_fwd_pyramid_plain(cur, out_p, first, lvls)
    err = max_abs_err(out_k, out_p)
    if not timed:
        return err, None, None, None, None
    kern = lambda: sbt.haar_fwd_pyramid(cur, out_k, first, lvls)  # noqa
    return (err, cuda_ms(kern, 50),
            cuda_ms(lambda: sbt._haar_fwd_pyramid_plain(cur, out_p, first,
                                                        lvls), 5),
            device_ms(kern, 50), work_haar(*cur.shape))


def check_mc(dev, enc, imgs, mv, seed):
    """compensate_frame on the P frame with the most intra blocks, with
    its HME field and with a fuzzed one (random modes and submasks, MVs
    far past the plane edges), kernel vs plain: (max_abs_err, kernel ms,
    plain ms, kernel device ms, (bytes, ops), intra blocks), the times
    and work on the HME field."""
    import torch

    from dsv1_tpu_torch.ops import bmc, mc
    H, W, nbh, nbv = enc.h, enc.w, enc.nbh, enc.nbv
    k = int(mv["nintra"].argmax())
    gen = torch.Generator().manual_seed(seed)

    def fuzz(hi, lo=0):
        return torch.randint(lo, hi, (nbv * nbh,), generator=gen,
                             dtype=torch.int32).to(dev)

    fields = [tuple(mv[key][k] for key in ("mode", "mvx", "mvy",
                                           "submask")),
              (fuzz(2), fuzz(4 * W, -4 * W), fuzz(4 * H, -4 * H), fuzz(16))]
    img, geo = imgs[0][k], (enc.layouts[0], enc.blk_w, enc.blk_h, nbh, nbv)
    err = max(max_abs_err(mc.predict_frame(img, *geo, *f),
                          mc.predict_frame_plain(img, *geo, *f))
              for f in fields)
    f = fields[0]
    kern = lambda: bmc.compensate_frame(img, *geo, *f)  # noqa: E731
    planes, _ = mc.frame_geometry(*geo[:3])
    return (err, cuda_ms(kern, 50),
            cuda_ms(lambda: mc.predict_frame_plain(img, *geo, *f), 5),
            device_ms(kern, 50), work_mc(planes, nbh, nbv, f),
            int(mv["nintra"][k]))


def phase_kernels(dev, bound, clips):
    """Each kernel vs its plain version at the main path's 1080p and 4K
    shapes, on the arguments the main path itself passes to the kernel."""
    import torch

    from dsv1_tpu_torch.ops import hme_kernels as hk

    _yuv, frames = clips["1080p"]
    enc, imgs, mv, calls = gop_motion(dev, frames)
    H, W = frames[0][0].shape
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
    work = [work_hme_refine(a) for a in lvl_args]
    rows.append(row("hme_refine", "dsv1_tpu_torch/csrc/hme.cu",
                    "dsv1_tpu/ops/pallas_hme.py:130", err, ms, plain_ms,
                    (sum(x for x, _ in work), sum(y for _, y in work)),
                    bound, shape=f"1080p levels {enc.levels}..1, B={B}"))

    # --- level 0
    err = max_abs_err(hk.refine_base(*bargs), hk.refine_base_plain(*bargs))
    ms = cuda_ms(lambda: hk.refine_base(*bargs), 20)
    plain_ms = cuda_ms(lambda: hk.refine_base_plain(*bargs), 3)
    rows.append(row("hme_base", "dsv1_tpu_torch/csrc/hme.cu",
                    "dsv1_tpu/ops/pallas_hme.py:339", err, ms, plain_ms,
                    work_hme_base(bargs), bound,
                    shape=f"1080p B={B} nb={nbh * nbv} {bw}x{bh}"))

    # --- MC, one call per frame: 1080p here, 4K below
    mc_1080 = check_mc(dev, enc, imgs, mv, 11)
    del imgs, mv, calls, lvl_args, bargs

    # --- the 4K GOP: level 0 is what the JAX package runs as its banded
    # kernel there (planes past MAX_PLANE_BYTES); the port's one kernel
    _yuv, frames4 = clips["4k_cli"]
    enc4, imgs4, mv4, calls4 = gop_motion(dev, frames4)
    H4, W4 = frames4[0][0].shape
    (bargs4,) = [a for name, a in calls4 if name == "hme_base"]
    B4 = bargs4[0].shape[0]
    err = max_abs_err(hk.refine_base(*bargs4), hk.refine_base_plain(*bargs4))
    ms = cuda_ms(lambda: hk.refine_base(*bargs4), 10)
    plain_ms = cuda_ms(lambda: hk.refine_base_plain(*bargs4), 2)
    rows.append(row("hme_base_banded", "dsv1_tpu_torch/csrc/hme.cu",
                    "dsv1_tpu/ops/pallas_hme.py:662", err, ms, plain_ms,
                    work_hme_base(bargs4), bound,
                    shape=f"4K B={B4} nb={enc4.nbh * enc4.nbv} "
                          f"{enc4.blk_w}x{enc4.blk_h}"))
    mc_4k = check_mc(dev, enc4, imgs4, mv4, 12)
    del imgs4, mv4, calls4, bargs4
    err, ms, plain_ms, dev_ms, work, nintra = mc_1080
    err4, ms4, plain_ms4, dev_ms4, work4, nintra4 = mc_4k
    rows.append(row("mc", "dsv1_tpu_torch/csrc/mc.cu",
                    "dsv1_tpu/ops/pallas_mc.py:38", max(err, err4), ms,
                    plain_ms, work, bound,
                    shape="one 1080p frame, 3 planes (HME field); *_4k: "
                          "one 3840x2160 frame; errors also on a fuzzed "
                          "field", device_ms=dev_ms, intra_blocks=nintra,
                    ms_4k=ms4, plain_ms_4k=plain_ms4, device_ms_4k=dev_ms4,
                    bound_ms_4k=bound(*work4)[0], intra_blocks_4k=nintra4))

    # --- the Haar pyramid of one plane: 1080p luma P and I, 4K luma P,
    # and odd shapes past 6 levels (errors only)
    err_p, ms, plain_ms, dev_ms, work = check_haar(dev, H, W, True, 1)
    err_i, ms_i, plain_ms_i, dev_ms_i, work_i = check_haar(dev, H, W,
                                                           False, 2)
    err4, ms4, plain_ms4, dev_ms4, work4 = check_haar(dev, H4, W4, True, 3)
    err_odd = max(check_haar(dev, h, w, p, 4, timed=False)[0]
                  for h, w, p in ((130, 200, True), (70, 130, False),
                                  (300, 1, True), (1, 300, True),
                                  (84, 100, True), (540, 960, False)))
    rows.append(row("haar_fwd", "dsv1_tpu_torch/csrc/sbt.cu",
                    "tools/bench_haar.py:169",
                    max(err_p, err_i, err4, err_odd), ms, plain_ms, work,
                    bound, shape=f"luma P pyramid {H}x{W} (levels 1..); "
                                 f"*_i: I, levels 2..; *_4k: {H4}x{W4} P",
                    device_ms=dev_ms, ms_i=ms_i, plain_ms_i=plain_ms_i,
                    device_ms_i=dev_ms_i, bound_ms_i=bound(*work_i)[0],
                    ms_4k=ms4, plain_ms_4k=plain_ms4, device_ms_4k=dev_ms4,
                    bound_ms_4k=bound(*work4)[0]))
    torch.cuda.empty_cache()
    for r in rows:
        emit({"phase": "kernels", **r})
        if r["max_abs_err"] != 0:
            raise AssertionError(f"kernel {r['name']} disagrees with its "
                                 f"plain version")
    return rows


def phase_edges(dev):
    """The whole encode + decode on the GPU (kernels) and on the CPU
    (plain versions) must give the same bytes at geometries and modes
    the golden clips do not reach: partial right and bottom blocks,
    4:4:4 chroma, per-frame ABR."""
    import dsv1_tpu_torch as dt
    from dsv1_tpu_torch.utils import corpus

    cases = ((100, 84, dt.SUBSAMP_420, dt.EncoderConfig(gop=4,
                                                        stable_refresh=3)),
             (96, 80, dt.SUBSAMP_444, dt.EncoderConfig(gop=4,
                                                       stable_refresh=3)),
             (96, 80, dt.SUBSAMP_420, dt.EncoderConfig(
                 gop=4, stable_refresh=3, rc_mode=dt.RATE_CONTROL_ABR,
                 bitrate=300 * 1024, quality=1900,
                 max_quality=dt.MAX_QUALITY)))
    for w, h, subsamp, cfg in cases:
        frames = corpus.split_frames(corpus.make_clip(w, h, subsamp, 8,
                                                      seed=5),
                                     w, h, subsamp, 8)
        meta = dt.Metadata(w, h, subsamp)
        gpu = dt.encode_stream_gops(frames, meta, cfg, device=dev)
        cpu = dt.encode_stream_gops(frames, meta, cfg, device="cpu")
        dg = dt.decode_stream_gops(gpu, device=dev)[1]
        dc = dt.decode_stream_gops(gpu, device="cpu")[1]
        same_dec = len(dg) == len(dc) == len(frames) and all(
            (a == b).all() for (_, pa), (_, pb) in zip(dg, dc)
            for a, b in zip(pa, pb))
        emit({"phase": "edges", "size": f"{w}x{h}", "subsamp": subsamp,
              "rc_mode": cfg.rc_mode, "stream_equal": gpu == cpu,
              "decode_equal": bool(same_dec)})
        if gpu != cpu or not same_dec:
            raise AssertionError(f"{w}x{h}: GPU and CPU paths disagree")


def check_launches(path, launches):
    for k in KERNELS:
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"kernel {k} was not launched on the "
                                 f"{path} path")


def phase_slice(dev, smi, golden, clips):
    """Main path 1: encode + decode both CRF golden clips on the GPU."""
    import torch

    import dsv1_tpu_torch as dt
    from dsv1_tpu_torch.kernels.build import LAUNCHES
    from dsv1_tpu_torch.utils.golden import GOP, QUALITY_PCT, decoded_bytes

    results = []
    LAUNCHES.clear()
    for name in SLICE_CLIPS:
        gold = golden[name]
        yuv, frames = clips[name]
        if sha(yuv) != gold["clip_sha256"]:
            raise AssertionError(f"{name}: input clip differs from the "
                                 "golden clip")
        meta = dt.Metadata(gold["width"], gold["height"], dt.SUBSAMP_420)
        cfg = dt.EncoderConfig(quality=dt.quality_percent(QUALITY_PCT),
                               gop=GOP, stable_refresh=GOP - 1)
        for _rep in range(ENCODE_REPS):
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
    check_launches("slice", launches)
    return launches


def phase_cli(dev, smi, golden, clips):
    """Main path 2: the CLI's default encode and decode, through files,
    of the CIF and 4K CLI clips. Returns the launches per clip."""
    import torch

    from dsv1_tpu_torch import cli
    from dsv1_tpu_torch.kernels.build import LAUNCHES
    from dsv1_tpu_torch.utils.golden import cli_decode_args, cli_encode_args

    per_path = {}
    with tempfile.TemporaryDirectory() as td:
        for name in CLI_CLIPS:
            gold = golden[name]
            yuv, _frames = clips[name]
            if sha(yuv) != gold["clip_sha256"]:
                raise AssertionError(f"{name}: input clip differs from the "
                                     "golden clip")
            inp, dsv, out = (Path(td) / f for f in ("in.yuv", "s.dsv",
                                                     "o.yuv"))
            inp.write_bytes(yuv)
            torch.cuda.synchronize()
            LAUNCHES.clear()
            t0 = time.perf_counter()
            if cli.main(cli_encode_args(name, inp, dsv), device=dev) != 0:
                raise AssertionError(f"{name}: CLI encode failed")
            t_enc = time.perf_counter() - t0
            t0 = time.perf_counter()
            if cli.main(cli_decode_args(dsv, out), device=dev) != 0:
                raise AssertionError(f"{name}: CLI decode failed")
            t_dec = time.perf_counter() - t0
            per_path[name] = dict(LAUNCHES)
            stream = dsv.read_bytes()
            ok_s = sha(stream) == gold["stream_sha256"]
            ok_d = sha(out.read_bytes()) == gold["decode_sha256"]
            n = gold["frames"]
            emit({"phase": "cli", "clip": name,
                  "size": f"{gold['width']}x{gold['height']}",
                  "frames": n, "argv": gold["argv"],
                  "stream_bytes": len(stream), "stream_sha256_ok": ok_s,
                  "decode_sha256_ok": ok_d, "encode_fps": n / t_enc,
                  "decode_fps": n / t_dec, "launches": per_path[name],
                  "card": smi})
            if not (ok_s and ok_d):
                raise AssertionError(f"{name}: CLI stream or decode "
                                     "differs from golden")
            check_launches(name, per_path[name])
    return per_path


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    # fail before printing anything when the port is not beside this file
    sys.path.insert(0, str(ROOT))
    import dsv1_tpu_torch  # noqa: F401
    from dsv1_tpu_torch.utils import golden as g

    smi, clock_hz = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    golden = g.load()
    clips = {name: g.clip_frames(name) for name in g.CLIPS}
    rows = phase_kernels(dev, Bound(clock_hz), clips)
    phase_edges(dev)
    slice_l = phase_slice(dev, smi, golden, clips)
    cli_l = phase_cli(dev, smi, golden, clips)
    path_launches = {"mc": slice_l["mc"],
                     "hme_refine": slice_l["hme_refine"],
                     "hme_base": slice_l["hme_base"],
                     "hme_base_banded": cli_l["4k_cli"]["hme_base"],
                     "haar_fwd": slice_l["haar_fwd"]}
    for r in rows:
        r["launches"] = path_launches[r["name"]]
    emit({"kernels": [{k: r[k] for k in ROW_KEYS} for r in rows]})
    loaded = sorted(m for m in sys.modules
                    if m.startswith(("jax", "dsv1_tpu"))
                    and m.split(".")[0] != "dsv1_tpu_torch")
    if loaded:
        raise AssertionError(f"the port's run loaded {loaded}")
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
