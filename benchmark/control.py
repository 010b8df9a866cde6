"""The control of the comparison that decides `correct`: the reference
with one guarantee broken (harness/check.py `control`) put in the
program's place, on a cell's own inputs at its own size, against the
plain reference that judges the cell's configuration. Prints, for each
seed, the numbers a run compares; a sound comparison reads them above
their limits.

    python3 benchmark/control.py --workload CELL --seeds 11,12,13

Runs on the first CUDA device (the reference needs no mesh), or with
--cpu on the CPU."""

import argparse
import json
import shutil
import sys
import tempfile
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def readings(cfg: dict, tr: dict, seed: int, dev) -> dict:
    """The numbers compared, for the control's answers on every clip of
    the seed's pool."""
    from harness import check, traffic
    ref = check.Reference(cfg, dev)
    clips = traffic.pool(cfg, tr, seed)
    tmp = Path(tempfile.mkdtemp(prefix="dsv1control-"))
    nums = {}
    try:
        for k, clip in enumerate(clips):
            frames = traffic.frames(cfg, clip)
            if cfg["api"] == "cli":
                inp = tmp / f"in{k}.yuv"
                inp.write_bytes(clip)
                want = ref.cli_encode(inp, tmp / "ref.dsv")
                with check.control(cfg):
                    got = ref.cli_encode(inp, tmp / "ctl.dsv")
            else:
                want = ref.encode(frames)
                with check.control(cfg):
                    got = ref.encode(frames)
            if tr["op"] == "encode":
                d = {"stream_diff_bytes": check.diff_bytes(got, want)}
            else:
                truth = ref.decode(want)
                with check.control(cfg):
                    dec = ref.decode(want)
                d = {"input_stream_diff_bytes": check.diff_bytes(got, want),
                     "decoded_diff_samples": check.diff_frames(dec, truth)}
            for key, v in d.items():
                nums[key] = max(nums.get(key, 0), v)
        return nums
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(BENCH)]
    import torch
    from harness import spec
    if not args.cpu and not torch.cuda.is_available():
        print("control.py: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cpu" if args.cpu else "cuda")
    bench = spec.load()
    w = spec.workload(bench, args.workload)
    cfg, tr = spec.config(bench, w["config"]), spec.traffic(w["traffic"])
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": readings(cfg, tr, seed, dev)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
