"""A traced run of a cell at another segment length and pool size, with
each chunk of GOPs of the traced slice listed as overflowed (1) or not
(0): whether a cell's per-layer readings and its overflow hold at a
longer segment or file.

    python3 benchmark/probe_length.py --workload CELL --seed N \\
        --frames F --pool P --requests R

Prints the harness's progress lines, the chunks' overflow, then the
result line of the traced run (correct as in run.py)."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


class Logged(collections.Counter):
    """The program's counters, keeping the order in which chunks and
    overflow redos were counted since the last clear."""
    log = []

    def __setitem__(self, key, value):
        if key in ("chunks", "overflow_redos"):
            Logged.log.append(key)
        super().__setitem__(key, value)

    def clear(self):
        Logged.log.clear()
        super().clear()


def by_chunk(log: list) -> list:
    """1 for each chunk during which an overflow redo was counted."""
    out = []
    for key in log:
        if key == "chunks":
            out.append(0)
        elif out:
            out[-1] = 1
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--frames", type=int, required=True)
    ap.add_argument("--pool", type=int, required=True)
    ap.add_argument("--requests", type=int, required=True)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(BENCH)]
    import torch
    from harness import cell, program, spec
    if not torch.cuda.is_available():
        print("probe_length.py: no CUDA device", file=sys.stderr)
        return 2
    bench = spec.load()
    w = spec.workload(bench, args.workload)
    cfg, tr = spec.config(bench, w["config"]), spec.traffic(w["traffic"])
    cfg["segment_frames"] = args.frames
    tr.update(pool=args.pool, trace_requests=args.requests)
    program.stats().__class__ = Logged
    devices = [torch.device("cuda", i) for i in range(w["chips"])]
    torch.cuda.set_device(devices[0])
    out = cell.run(args.workload, args.seed, 0, True, devices, T_START,
                   cfg=cfg, tr=tr, say=lambda s: print(s, flush=True))
    chunks = by_chunk(Logged.log)
    print(f"overflow by chunk ({len(chunks)} chunks, {sum(chunks)} "
          f"overflowed): {' '.join(map(str, chunks))}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
