"""The benchmark of dsv1_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout on a machine with the cards the cell asks
for. Loads the cell's configuration and traffic (BENCHMARK.json), makes
its clips from the seed, warms one request of each clip, then measures
requests back to back for S seconds (--trace 0: the end-to-end metrics) or traces a
fixed number of whole requests under torch.profiler (--trace 1: the
per-layer metrics), checks the answers against the frozen plain
reference, and prints the result as the last line of standard output.
Exits non-zero with no result where there is no CUDA device or too few,
where the program is missing, or where JAX or the JAX package was
loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    # every build and kernel cache at a fixed path inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    sys.path[:0] = [str(ROOT), str(BENCH)]
    from harness import cell, spec
    bench = spec.load()
    chips = spec.workload(bench, args.workload)["chips"]
    import torch
    if not torch.cuda.is_available():
        print("run.py: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"run.py: the cell needs {chips} CUDA devices, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    if not (ROOT / "dsv1_tpu_torch").is_dir():
        print("run.py: the program (dsv1_tpu_torch) is not in this "
              "checkout", file=sys.stderr)
        return 3
    devices = [torch.device("cuda", i) for i in range(chips)]
    torch.cuda.set_device(devices[0])
    out = cell.run(args.workload, args.seed, args.seconds, bool(args.trace),
                   devices, T_START, say=lambda s: print(s, flush=True))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
