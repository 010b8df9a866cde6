"""One rank of the port's GOP-sharded encode across processes.

Runs `dsv1_tpu_torch.parallel.multihost.run_distributed_shard` (gloo on
torch.distributed) on a golden clip (`--clip NAME`, with its config from
dsv1_tpu_torch/utils/golden.py) or on a synthetic CRF clip
(`--size WxH --frames N --gop G --stabref S --seed K [--cut F]`: the
port's corpus.make_clip, its luma halved from frame F on). Rank 0 writes
the muxed stream to OUT; every rank prints one JSON line with its
encode seconds, handshake rounds and mux seconds. Start one process per
rank, all with the same coordinator address:

    python3 tools/torch_shard_worker.py 127.0.0.1:29500 2 0 out.dsv \\
        --clip cif_batch --device cuda &
    python3 tools/torch_shard_worker.py 127.0.0.1:29500 2 1 out.dsv \\
        --clip cif_batch --device cuda
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("coordinator")
    ap.add_argument("nprocs", type=int)
    ap.add_argument("rank", type=int)
    ap.add_argument("out")
    ap.add_argument("--clip", default=None)
    ap.add_argument("--size", default="96x80")
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--gop", type=int, default=4)
    ap.add_argument("--stabref", type=int, default=3)
    ap.add_argument("--seed", type=int, default=31)
    ap.add_argument("--cut", type=int, default=-1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch
    torch.set_num_threads(1)
    import dsv1_tpu_torch as dt
    from dsv1_tpu_torch.parallel.multihost import run_distributed_shard
    from dsv1_tpu_torch.utils import corpus, golden

    if args.clip:
        _yuv, frames = golden.clip_frames(args.clip)
        meta, cfg, _kw = golden.encode_args(args.clip)
    else:
        w, h = (int(v) for v in args.size.split("x"))
        yuv = corpus.make_clip(w, h, dt.SUBSAMP_420, args.frames,
                               seed=args.seed, cut_at=args.cut)
        frames = corpus.split_frames(yuv, w, h, dt.SUBSAMP_420, args.frames)
        meta = dt.Metadata(w, h, dt.SUBSAMP_420)
        cfg = dt.EncoderConfig(gop=args.gop, stable_refresh=args.stabref)
    stream, (enc_s, rounds, mux_s) = run_distributed_shard(
        args.coordinator, args.nprocs, args.rank, frames, meta, cfg,
        out_path=args.out if args.rank == 0 else None, device=args.device)
    print(json.dumps({"rank": args.rank, "encode_s": enc_s,
                      "rounds": rounds, "mux_s": mux_s,
                      "stream_bytes": None if stream is None
                      else len(stream)}), flush=True)


if __name__ == "__main__":
    main()
