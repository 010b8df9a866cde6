"""Where the time goes in the port's GPU encode and decode.

Encodes one golden clip (dsv1_tpu_torch/utils/golden.py) on the GPU
under torch.profiler: the CRF clips (`cif`, `1080p`) through
`dsv1_tpu_torch.encode_stream_gops`, the CLI clips (`cif_cli`, `4k_cli`)
through `dsv1_tpu_torch.cli.main` with the CLI's defaults (per-frame
ABR), from and to files, the sequential clips with their own CLI
arguments, the `*_batch*` clips through `encode_stream_gops` with the
arguments utils/golden.py API gives them (`--gops-per-device N`
overrides the chunk of an `encode_stream_gops` clip). Reads the layer
spans the encoder records (per chunk of GOPs `gop.upload`, `gop.motion`,
`gop.stability`, `gop.recon_chain` with `gop.rate_read` inside it under
ABR, `gop.pack`, and `gop.intra_core`, `gop.intra_compact` and
`gop.intra_scan` (inside `gop.pack`) at gop 0, and `encode.intake`,
`encode.read` (the blocking reads, inside the `gop.*` spans),
`encode.finish`; parallel/gop.py; `cli.read`, `cli.write`, cli.py; per
frame of the sequential Encoder `seq.motion`, `seq.core`, `seq.pack`;
models/encoder.py; the decode's `decode.parse`, `decode.upload`,
`decode.chain`, `decode.read`, parallel/decode.py), the device busy share, the
top device kernels, the device kernels launched per encoded frame
(kernel events, memcpy and memset left out, over the clip's frames), the
device-to-host copies per frame (the host's reads of the device) and
their bytes per frame (the `bytes` of the trace's device-to-host memcpy
events), and the encode's `overflow_redos` (GOPs whose compacted planes
overflowed, dsv1_tpu_torch/utils/stats.py; null on a tree without
it); then profiles the decode of the stream the same way. The same
encode also runs once without the profiler, so the profiler's own cost
shows, and the decode once without it too. The last line sums up:
the encode's kernels, host reads and their bytes per frame, both
busy shares and unprofiled walls, and the spans' seconds. Needs a CUDA
device.

    python3 tools/torch_profile.py [--clip NAME] [--out FILE]
        [--gops-per-device N]
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SPANS = ("gop.upload", "gop.motion", "gop.stability", "gop.recon_chain",
         "gop.rate_read", "gop.pack", "gop.intra_core", "gop.intra_compact",
         "gop.intra_scan", "seq.motion", "seq.core", "seq.pack",
         "encode.intake", "encode.read", "encode.finish", "cli.read",
         "cli.write", "decode.parse", "decode.upload", "decode.chain",
         "decode.read")


def _sync():
    import torch
    torch.cuda.synchronize()
    return time.perf_counter()


def d2h_bytes(prof):
    """Bytes of the device-to-host memcpy events in the profiler's trace
    (None when the trace gives no bytes)."""
    import tempfile
    with tempfile.TemporaryDirectory() as td:
        path = Path(td) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
    sizes = [e.get("args", {}).get("bytes") for e in events
             if e.get("cat") == "gpu_memcpy" and "DtoH" in e.get("name", "")]
    if not sizes or None in sizes:
        return None
    return sum(sizes)


def profile(fn):
    """One fn() call under torch.profiler: (wall seconds, device busy
    share, host seconds per encoder span, top device kernels, kernel
    launches, device-to-host copies, their bytes)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    _sync()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = _sync() - t0
    rows, spans = [], {}
    busy_us, kernels, reads = 0.0, 0, 0
    for e in prof.key_averages():
        if e.key in SPANS:
            # a span also shows as a device-side range: not a kernel
            if e.device_type == DeviceType.CPU:
                spans[e.key] = e.cpu_time_total * 1e-6
            continue
        if e.device_type != DeviceType.CUDA:
            continue   # host ops; their kernels are listed on their own
        dt_us = e.self_device_time_total
        if dt_us > 0:
            busy_us += dt_us
            rows.append((dt_us, e.count, e.key))
            if not e.key.startswith(("Memcpy", "Memset")):
                kernels += e.count
            elif e.key.startswith("Memcpy DtoH"):
                reads += e.count
    rows.sort(reverse=True)
    torch.cuda.synchronize()
    return (wall, busy_us * 1e-6 / wall, spans, rows[:15], kernels, reads,
            d2h_bytes(prof))


def main():
    from dsv1_tpu_torch.utils.golden import CLIPS

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clip", choices=sorted(CLIPS), default="1080p")
    ap.add_argument("--out", default=None, help="also write JSON here")
    ap.add_argument("--gops-per-device", type=int, default=None,
                    help="GOPs a chunk of an encode_stream_gops clip")
    args = ap.parse_args()
    import subprocess
    import tempfile

    import torch

    import dsv1_tpu_torch as dt
    from dsv1_tpu_torch import cli
    from dsv1_tpu_torch.utils.golden import (cli_decode_args,
                                             cli_encode_args, clip_frames,
                                             encode_args)

    if not torch.cuda.is_available():
        raise SystemExit("torch_profile: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    dev = torch.device("cuda", 0)
    yuv, frames = clip_frames(args.clip)
    td = Path(tempfile.mkdtemp())
    inp, dsv, out = td / "in.yuv", td / "s.dsv", td / "o.yuv"
    inp.write_bytes(yuv)

    if CLIPS[args.clip][4] is None:
        meta, cfg, kw = encode_args(args.clip)
        if args.gops_per_device is not None:
            kw["gops_per_device"] = args.gops_per_device

        def encode():
            return dt.encode_stream_gops(frames, meta, cfg, dev, **kw)

        def decode(stream):
            return dt.decode_stream_gops(stream, device=dev)
    else:
        def encode():
            assert cli.main(cli_encode_args(args.clip, inp, dsv),
                            device=dev) == 0
            return dsv.read_bytes()

        def decode(_stream):
            assert cli.main(cli_decode_args(dsv, out), device=dev) == 0

    try:
        from dsv1_tpu_torch.utils.stats import STATS
    except ImportError:   # a tree from before the compaction
        STATS = None
    stream = encode()   # warm-up
    t0 = _sync()
    encode()
    plain_wall = _sync() - t0
    decode(stream)      # warm-up
    t0 = _sync()
    decode(stream)
    dec_plain_wall = _sync() - t0
    if STATS is not None:
        STATS.clear()
    enc_wall, enc_busy, spans, enc_top, enc_k, enc_r, enc_b = profile(encode)
    redos = None if STATS is None else STATS["overflow_redos"]
    dec_wall, dec_busy, dec_spans, dec_top, dec_k, dec_r, dec_b = profile(
        lambda: decode(stream))
    nf = len(frames)

    def per_frame(b):
        return None if b is None else b / nf
    for f in (inp, dsv, out):
        f.unlink(missing_ok=True)
    td.rmdir()
    res = {"clip": args.clip, "frames": len(frames), "card": card,
           "gops_per_device": args.gops_per_device,
           "encode": {"wall_s": plain_wall, "profiled_wall_s": enc_wall,
                      "spans_s": spans, "device_busy_share": enc_busy,
                      "kernels_per_frame": enc_k / nf,
                      "host_reads_per_frame": enc_r / nf,
                      "d2h_bytes_per_frame": per_frame(enc_b),
                      "overflow_redos": redos,
                      "top_kernels_us": enc_top},
           "decode": {"wall_s": dec_plain_wall,
                      "profiled_wall_s": dec_wall,
                      "spans_s": dec_spans,
                      "device_busy_share": dec_busy,
                      "kernels_per_frame": dec_k / nf,
                      "host_reads_per_frame": dec_r / nf,
                      "d2h_bytes_per_frame": per_frame(dec_b),
                      "top_kernels_us": dec_top}}
    print(json.dumps(res, indent=1))
    print(json.dumps({"clip": args.clip, "card": card,
                      "gops_per_device": args.gops_per_device,
                      "encode_kernels_per_frame": enc_k / nf,
                      "encode_host_reads_per_frame": enc_r / nf,
                      "encode_d2h_bytes_per_frame": per_frame(enc_b),
                      "overflow_redos": redos,
                      "decode_kernels_per_frame": dec_k / nf,
                      "encode_busy_share": enc_busy,
                      "decode_busy_share": dec_busy,
                      "encode_wall_s": plain_wall,
                      "decode_wall_s": dec_plain_wall, "spans_s": spans}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
