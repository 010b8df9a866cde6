"""Times the port's forward Haar pyramid and its MC prediction on the GPU.

    python3 tools/torch_kernel_times.py [--root DIR] [--e2e N] [--out FILE]

The two units of work the recon chain hands to the Haar and MC kernels,
at the main path's shapes, on random coefficients and on a golden
clip's own motion field (the P frame with the most intra blocks of the
first GOP, as chip_smoke.py picks it):

- `sbt.fwd_sbt` of one 1080p luma P plane, one 1080p luma I plane (its
  B4T level included) and one 3840x2160 luma P plane;
- the MC prediction of the three planes of one 1080p and one 3840x2160
  P frame: `bmc.compensate_frame` where the port has it, else
  `bmc.compensate_plane` for c = 0, 1, 2 (so one script times a tree
  from before the frame-wide kernel too).

For each: the CUDA-event mean per call over a loop of calls (the
wrappers' host work included), the device time per call summed from
torch.profiler's kernel events, and the kernels launched per call.
`--e2e N` also times N encodes (`encode_stream_gops`, CRF) and N
decodes of the 1080p golden clip after a warm-up, each to its last
device sync, on the host clock.
`--root` imports the port from another checkout (for example an
unpacked parent commit), so two trees are timed by one script in one
call. Needs a CUDA device.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def event_ms(fn, reps: int) -> float:
    """Mean CUDA-event time of fn() over reps calls, after a warm-up."""
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


def device_ms(fn, reps: int):
    """(device ms per call, kernels per call) from torch.profiler's
    kernel events over reps calls (memcpy and memset events left out)."""
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
    us, n = 0.0, 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        if e.key.startswith(("Memcpy", "Memset")):
            continue
        us += e.self_device_time_total
        n += e.count
    return us * 1e-3 / reps, n / reps


def timed(name, fn, reps):
    ev = event_ms(fn, reps)
    dev, kern = device_ms(fn, reps)
    return {"name": name, "ms": ev, "device_ms": dev,
            "kernels_per_call": kern}


def haar_cases(dev):
    import numpy as np
    import torch

    from dsv1_tpu_torch.ops import sbt
    out = []
    for tag, (h, w), is_p in (("1080p luma P", (1080, 1920), True),
                              ("1080p luma I", (1080, 1920), False),
                              ("4K luma P", (2160, 3840), True)):
        a = np.random.default_rng(h + is_p).integers(-255, 256, (h, w))
        coefs = torch.from_numpy(a.astype(np.int32)).to(dev)
        out.append(timed(f"fwd_sbt {tag}",
                         lambda c=coefs, p=is_p: sbt.fwd_sbt(c, p), 50))
    return out


def mc_case(dev, clip):
    import numpy as np
    import torch

    import dsv1_tpu_torch as dt
    from dsv1_tpu_torch.ops import bmc
    from dsv1_tpu_torch.parallel.gop import build_gop_encoder
    from dsv1_tpu_torch.utils.golden import GOP, QUALITY_PCT, clip_frames

    _yuv, frames = clip_frames(clip)
    h, w = frames[0][0].shape
    enc = build_gop_encoder(dt.SUBSAMP_420, w, h, GOP,
                            dt.quality_percent(QUALITY_PCT), True, 4, 50,
                            GOP - 1, 0, str(dev))
    packed = torch.from_numpy(np.stack([
        np.concatenate([np.asarray(p, np.uint8).ravel() for p in f])
        for f in frames[:GOP]])).to(dev)
    imgs, _al, mv, _hr = enc.motion(packed)
    k = int(mv["nintra"].argmax())
    img, lay = imgs[0][k], enc.layouts[0]
    fields = tuple(mv[key][k] for key in ("mode", "mvx", "mvy", "submask"))
    geo = (enc.blk_w, enc.blk_h, enc.nbh, enc.nbv)
    if hasattr(bmc, "compensate_frame"):
        def fn():
            return bmc.compensate_frame(img, lay, *geo, *fields)
        unit = "compensate_frame"
    else:
        def fn():
            return [bmc.compensate_plane(img, lay, c, *geo, *fields)
                    for c in range(3)]
        unit = "compensate_plane x3"
    r = timed(f"MC {clip} frame ({unit})", fn, 50)
    r["intra_blocks"] = int(mv["nintra"][k])
    return r


def e2e_case(dev, reps: int):
    """Host seconds of each of reps encodes and decodes of the 1080p
    golden clip (24 frames, gop 12, CRF), after one warm-up of each."""
    import torch

    import dsv1_tpu_torch as dt
    from dsv1_tpu_torch.utils.golden import GOP, QUALITY_PCT, clip_frames

    _yuv, frames = clip_frames("1080p")
    h, w = frames[0][0].shape
    meta = dt.Metadata(w, h, dt.SUBSAMP_420)
    cfg = dt.EncoderConfig(quality=dt.quality_percent(QUALITY_PCT), gop=GOP,
                           stable_refresh=GOP - 1)
    stream = dt.encode_stream_gops(frames, meta, cfg, device=dev)
    dt.decode_stream_gops(stream, device=dev)
    enc, dec = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dt.encode_stream_gops(frames, meta, cfg, device=dev)
        torch.cuda.synchronize()
        enc.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        dt.decode_stream_gops(stream, device=dev)
        torch.cuda.synchronize()
        dec.append(time.perf_counter() - t0)
    return {"name": "1080p CRF encode/decode, 24 frames", "encode_s": enc,
            "decode_s": dec}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(ROOT),
                    help="checkout whose dsv1_tpu_torch is timed")
    ap.add_argument("--out", default=None, help="also write JSON here")
    ap.add_argument("--e2e", type=int, default=0, metavar="N",
                    help="also time N encodes and decodes of the 1080p clip")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_times: needs a CUDA device")
    import dsv1_tpu_torch
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    rows = haar_cases(dev) + [mc_case(dev, "1080p"), mc_case(dev, "4k_cli")]
    if args.e2e:
        rows.append(e2e_case(dev, args.e2e))
    res = {"root": str(Path(dsv1_tpu_torch.__file__).parent.parent),
           "card": card, "seconds": time.perf_counter() - t0, "rows": rows}
    print(json.dumps(res, indent=1))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
