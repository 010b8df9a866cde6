"""Where the time goes in the port's GPU encode and decode.

Encodes one golden clip (dsv1_tpu_torch/utils/golden.py) on the GPU
under torch.profiler: the CRF clips (`cif`, `1080p`) through
`dsv1_tpu_torch.encode_stream_gops`, the CLI clips (`cif_cli`, `4k_cli`)
through `dsv1_tpu_torch.cli.main` with the CLI's defaults (per-frame
ABR), from and to files. Reads the per-GOP layer spans the encoder
records (`gop.upload`, `gop.motion`, `gop.recon_chain` with
`gop.rate_read` inside it under ABR, `gop.pack`; parallel/gop.py), the
device busy share, the top device kernels and the device kernels
launched per encoded frame (kernel events, memcpy and memset left out,
over the clip's frames); then profiles the decode of the stream the
same way. The same encode also runs once without the profiler, so the
profiler's own cost shows. The last line sums up the encode: kernels
per frame and the `gop.recon_chain` seconds. Needs a CUDA device.

    python3 tools/torch_profile.py [--clip NAME] [--out FILE]
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SPANS = ("gop.upload", "gop.motion", "gop.recon_chain", "gop.rate_read",
         "gop.pack")


def _sync():
    import torch
    torch.cuda.synchronize()
    return time.perf_counter()


def profile(fn):
    """One fn() call under torch.profiler: (wall seconds, device busy
    share, host seconds per encoder span, top device kernels, kernel
    launches)."""
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
    busy_us, kernels = 0.0, 0
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
    rows.sort(reverse=True)
    torch.cuda.synchronize()
    return wall, busy_us * 1e-6 / wall, spans, rows[:15], kernels


def main():
    from dsv1_tpu_torch.utils.golden import CLIPS

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clip", choices=sorted(CLIPS), default="1080p")
    ap.add_argument("--out", default=None, help="also write JSON here")
    args = ap.parse_args()
    import subprocess
    import tempfile

    import torch

    import dsv1_tpu_torch as dt
    from dsv1_tpu_torch import cli
    from dsv1_tpu_torch.utils.golden import (GOP, QUALITY_PCT,
                                             cli_decode_args,
                                             cli_encode_args, clip_frames)

    if not torch.cuda.is_available():
        raise SystemExit("torch_profile: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    dev = torch.device("cuda", 0)
    yuv, frames = clip_frames(args.clip)
    h, w = frames[0][0].shape
    meta = dt.Metadata(w, h, dt.SUBSAMP_420)
    cfg = dt.EncoderConfig(quality=dt.quality_percent(QUALITY_PCT), gop=GOP,
                           stable_refresh=GOP - 1)
    td = Path(tempfile.mkdtemp())
    inp, dsv, out = td / "in.yuv", td / "s.dsv", td / "o.yuv"
    inp.write_bytes(yuv)

    if CLIPS[args.clip][4] is None:
        def encode():
            return dt.encode_stream_gops(frames, meta, cfg, device=dev)

        def decode(stream):
            return dt.decode_stream_gops(stream, device=dev)
    else:
        def encode():
            assert cli.main(cli_encode_args(args.clip, inp, dsv),
                            device=dev) == 0
            return dsv.read_bytes()

        def decode(_stream):
            assert cli.main(cli_decode_args(dsv, out), device=dev) == 0

    stream = encode()   # warm-up
    t0 = _sync()
    encode()
    plain_wall = _sync() - t0
    enc_wall, enc_busy, spans, enc_top, enc_k = profile(encode)
    dec_wall, dec_busy, _, dec_top, dec_k = profile(lambda: decode(stream))
    for f in (inp, dsv, out):
        f.unlink(missing_ok=True)
    td.rmdir()
    res = {"clip": args.clip, "frames": len(frames), "card": card,
           "encode": {"wall_s": plain_wall, "profiled_wall_s": enc_wall,
                      "spans_s": spans, "device_busy_share": enc_busy,
                      "kernels_per_frame": enc_k / len(frames),
                      "top_kernels_us": enc_top},
           "decode": {"profiled_wall_s": dec_wall,
                      "device_busy_share": dec_busy,
                      "kernels_per_frame": dec_k / len(frames),
                      "top_kernels_us": dec_top}}
    print(json.dumps(res, indent=1))
    print(json.dumps({"clip": args.clip, "card": card,
                      "encode_kernels_per_frame": enc_k / len(frames),
                      "decode_kernels_per_frame": dec_k / len(frames),
                      "recon_chain_s": spans.get("gop.recon_chain")}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
