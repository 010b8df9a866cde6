"""Launch shapes and per-phase cycles of the HME kernels on the GPU.

    python3 tools/torch_hme_probe.py [--shapes 128x8,128x1]
        [--clips cif,1080p,4k_cli] [--out FILE]

csrc/hme.cu launches both search kernels in one shape: kNT threads per
block and __launch_bounds__(kNT, kMinBlocks). For each listed shape
(threads x least blocks per SM) this builds two copies of
dsv1_tpu_torch/csrc with that shape patched into hme.cu, under
build/hme_probe/; the shipped sources are not changed. On each clip's
first GOP, with the arguments `hme_batch` passes its kernels:

- the first copy times `refine_coarse` and `refine_base_cm` and checks
  that their outputs equal the shipped build's. Two times per call:
  the CUDA-event mean of a loop of calls (the wrapper's host work
  included, as tools/torch_kernel_times.py times it), and the device
  time of the same loop queued behind a sleep kernel, so that the card
  runs the calls back to back however long the host takes to launch
  (torch.profiler, which that tool uses, lost kernel events when
  libraries were swapped in one process);
- the second also stamps clock64() on thread 0 of every
  `hme_base_kernel` thread block at the end of each of its phases and
  gives the mean cycles per thread block of each phase. Blocks share
  their SM, so a phase's cycles are its latency within a block, not
  its share of the SM's instruction slots.

Needs a CUDA device and nvcc.
"""

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SHAPES = "64x1,64x16,128x1,128x6,128x8,256x1,256x4"
SHAPE_LINE = "constexpr int kNT = 128, kMinBlocks = 8;"
SLEEP_CYCLES = 100_000_000   # about 50 ms of a 1.98 GHz SM clock
PHASES = ("load", "pass1", "pass2", "nbload", "filt1", "filt2", "hpsad",
          "stats", "epi")
# hme_base_kernel's first line after its set-up, then where each phase
# ends: the first match of each anchor after the one before
KERNEL = "hme_base_kernel(BaseArgs a) {\n"
START = "  const int wpr = BW >> 2;\n"
ANCHORS = ("  __syncthreads();\n", "  block_sum_u(v, red1);\n",
           "  block_sum_u(v2, red2);\n", "  __syncthreads();\n",
           "  __syncthreads();\n", "  __syncthreads();\n",
           "  __syncthreads();\n",
           "  rsv = __reduce_add_sync(0xffffffffu, rsv);\n",
           "  a.svar[o] = svar;\n")
STAMP_DEFS = """
__device__ unsigned long long dsv1_phase_cycles[%d];
#define DSV1_STAMP(k)                                                \\
  if (threadIdx.x == 0) {                                            \\
    const long long n_ = clock64();                                  \\
    atomicAdd(&dsv1_phase_cycles[k], (unsigned long long)(n_ - t_)); \\
    t_ = n_;                                                         \\
  }
"""
READ_FN = """
// Copies the phase counters to out and zeroes them.
extern "C" int dsv1_phase_read(unsigned long long* out) {
  static const unsigned long long zero[%d] = {0};
  cudaError_t e = cudaMemcpyFromSymbol(out, dsv1_phase_cycles,
                                       sizeof(zero));
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(dsv1_phase_cycles, zero, sizeof(zero));
  return (int)e;
}
"""


def patched(src: str, nt: int, mb: int, stamps: bool) -> str:
    """csrc/hme.cu with launch shape (nt, mb), and the phase stamps."""
    if src.count(SHAPE_LINE) != 1:
        raise SystemExit(f"csrc/hme.cu: no line {SHAPE_LINE!r}")
    src = src.replace(SHAPE_LINE,
                      f"constexpr int kNT = {nt}, kMinBlocks = {mb};")
    if not stamps:
        return src
    pos = src.index(START, src.index(KERNEL)) + len(START)
    src = src[:pos] + "  long long t_ = clock64();\n" + src[pos:]
    for k, anchor in enumerate(ANCHORS):
        pos = src.index(anchor, pos) + len(anchor)
        stamp = f"  DSV1_STAMP({k});\n"
        src = src[:pos] + stamp + src[pos:]
        pos += len(stamp)
    inc = '#include "common.cuh"\n'
    src = src.replace(inc, inc + STAMP_DEFS % len(PHASES), 1)
    return src + READ_FN % len(PHASES)


def queued_ms(fn, reps: int) -> float:
    """Device ms per call of reps calls of fn, queued behind a sleep
    kernel that outlasts their launch on the host, after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def use_library(kb, shipped, nt=None, mb=None, stamps=False):
    """Point the port's kernel loader at the shipped sources (nt None) or
    at a patched copy, built at first use; returns the library."""
    kb._lib = None
    if nt is None:
        kb.CSRC, kb.BUILD_DIR = shipped
        return kb.lib()
    d = ROOT / "build" / "hme_probe" / f"{nt}x{mb}{'_stamps' * stamps}"
    csrc = d / "csrc"
    if csrc.exists():
        shutil.rmtree(csrc)
    shutil.copytree(shipped[0], csrc)
    hme = csrc / "hme.cu"
    hme.write_text(patched(hme.read_text(), nt, mb, stamps))
    kb.CSRC, kb.BUILD_DIR = csrc, d / "lib"
    L = kb.lib()
    if stamps:
        L.dsv1_phase_read.argtypes = [ctypes.c_void_p]
        L.dsv1_phase_read.restype = ctypes.c_int
    return L


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default=SHAPES, metavar="NTxMB,...",
                    help="(threads x least blocks per SM) launch shapes")
    ap.add_argument("--clips", default="cif,1080p,4k_cli",
                    help="golden clips whose first GOP is searched")
    ap.add_argument("--out", default=None, help="also write JSON here")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tools"))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_hme_probe: needs a CUDA device")
    from torch_kernel_times import event_ms, gop_images, hme_calls

    from dsv1_tpu_torch.kernels import build as kb
    from dsv1_tpu_torch.ops import hme_kernels as hk
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    shipped = (kb.CSRC, kb.BUILD_DIR)
    use_library(kb, shipped)
    cases = {}
    for clip in args.clips.split(","):
        enc, imgs = gop_images(dev, clip)
        _fn, calls = hme_calls(enc, imgs)
        (cargs,) = [a for name, a in calls if name == "hme_coarse"]
        (bargs,) = [a for name, a in calls if name == "hme_base"]
        want = (hk.refine_coarse(*cargs), *hk.refine_base_cm(*bargs))
        cases[clip] = (f"{enc.blk_w}x{enc.blk_h}", cargs, bargs, want)
    rows = []
    for shape in args.shapes.split(","):
        nt, mb = (int(x) for x in shape.split("x"))
        use_library(kb, shipped, nt, mb)
        for clip, (blk, cargs, bargs, want) in cases.items():
            got = (hk.refine_coarse(*cargs), *hk.refine_base_cm(*bargs))
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            for name, fn in (("refine_coarse",
                              lambda: hk.refine_coarse(*cargs)),
                             ("refine_base_cm",
                              lambda: hk.refine_base_cm(*bargs))):
                r = {"name": f"{name} {clip} {blk} threads={nt} "
                             f"min_blocks={mb}", "ms": event_ms(fn, 20),
                     "device_ms": queued_ms(fn, 20),
                     "equal_to_shipped": same}
                rows.append(r)
                print(json.dumps(r), flush=True)
        L = use_library(kb, shipped, nt, mb, stamps=True)
        out = (ctypes.c_ulonglong * len(PHASES))()
        for clip, (blk, _cargs, bargs, _want) in cases.items():
            for _ in range(2):   # the second call is read
                hk.refine_base_cm(*bargs)
                torch.cuda.synchronize()
                kb.check(L.dsv1_phase_read(out), "dsv1_phase_read")
            blocks = bargs[0].shape[0] * bargs[5]
            cyc = {p: out[k] / blocks for k, p in enumerate(PHASES)}
            r = {"name": f"hme_base_kernel phases {clip} {blk} threads={nt} "
                         f"min_blocks={mb}", "cycles_per_block": cyc,
                 "total": sum(cyc.values())}
            rows.append(r)
            print(json.dumps(r), flush=True)
    use_library(kb, shipped)
    res = {"card": card, "seconds": time.perf_counter() - t0, "rows": rows}
    print(json.dumps({"card": card, "seconds": res["seconds"]}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
