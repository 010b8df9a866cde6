"""Launch shapes and per-phase cycles of the HME kernels on the GPU.

    python3 tools/torch_hme_probe.py [--kernels base,wide]
        [--shapes 128x8,128x1] [--wide-shapes 128x4]
        [--clips cif,1080p,4k_cli] [--root DIR] [--out FILE]

csrc/hme.cu gives each search kernel its launch shape as constants:
kNT threads per block and __launch_bounds__(kNT, kMinBlocks) for
`hme_level_kernel` and `hme_base_kernel` (`--shapes`), and kNT threads
and kWideMinBlocks for `hme_wide_kernel` (`--wide-shapes`, its threads
kNT; NTxMB1:MB2:MB3 gives efforts 1, 2, 3 their own bound, where the
tree has one for each). For each listed shape (threads x least blocks
per SM) this builds two copies of the tree's csrc with that shape
patched into hme.cu, under build/hme_probe/; the shipped sources are
not changed. On each clip's first GOP, with the arguments
`hme_batch` passes its kernels (the wide search: at efforts 1, 2 and 3
on the `pre` it computes at effort 3):

- the first copy times `refine_coarse` and `refine_base_cm` (`base`),
  or `refine_wide` at each effort (`wide`), and checks that their
  outputs equal the shipped build's. Two times per call: the CUDA-event
  mean of a loop of calls (the wrapper's host work included, as
  tools/torch_kernel_times.py times it), and the device time of the
  same loop queued behind a sleep kernel, so that the card runs the
  calls back to back however long the host takes to launch;
- the second also stamps clock64() on thread 0 of every thread block
  of `hme_base_kernel` and `hme_wide_kernel` at their HME_STAMP(k)
  markers (the end of phase k of its list below) and gives the mean
  cycles per thread block of each phase. Blocks share their SM, so a
  phase's cycles are its latency within a block, not its share of the
  SM's instruction slots.

`--kernels isa` measures the issue rate the HME bounds assume for
their SAD instruction (chip_smoke.py `hme_bounds`), VABSDIFF4.U8.ACC,
reached as `__vsadu4(a, y) + a` and as the PTX op that adds into its
accumulator, beside IDP.4A (`__dp4a`) and IMAD, whose rate, 64 a clock
per SM, the bounds take for every INT32 instruction. A block of 1024
threads on each SM runs 8 independent dependent chains of one step per
thread; the rate is the steps of a block over its clock64() cycles
(median over the SMs). cuobjdump -sass gives each loop's opcodes (one
per step) and the opcode counts of the tree's hme_wide_kernel<6>.

`--root` probes another checkout (for example an unpacked parent
commit): its csrc is patched and its port is imported, so two trees
are probed by one script; its kernels need the HME_STAMP markers.
Needs a CUDA device and nvcc.
"""

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SHAPES = "64x1,64x16,128x1,128x6,128x8,256x1,256x4"
SHAPE_LINE = "constexpr int kNT = 128, kMinBlocks = 8;"
WIDE_SHAPE = re.compile(r"constexpr int kWideMinBlocks(\[3\])? = "
                        r"(\d+|\{\d+, \d+, \d+\});")
SLEEP_CYCLES = 100_000_000   # about 50 ms of a 1.98 GHz SM clock
# per kernel: its first line, the counter slots it stamps and the phases
# of its HME_STAMP markers
KERNELS = {
    "base": {"head": "hme_base_kernel(BaseArgs a) {\n", "slot": 0,
             "markers": ("stage", "pass1", "pass2", "hp_filter", "hp_sad",
                         "finish")},
    "wide": {"head": "hme_wide_kernel(WideArgs a) {\n", "slot": 8,
             "markers": ("stage", "sums", "fullpel", "pick", "hp_filter",
                         "hp_grid", "finish")},
}
N_SLOTS = 16
STAMP_DEFS = """
__device__ unsigned long long dsv1_phase_cycles[%d];
#define DSV1_STAMP(k)                                                \\
  if (threadIdx.x == 0) {                                            \\
    const long long n_ = clock64();                                  \\
    atomicAdd(&dsv1_phase_cycles[k], (unsigned long long)(n_ - t_)); \\
    t_ = n_;                                                         \\
  }
#define HME_STAMP_START long long t_ = clock64();
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


def _body(src: str, head: str):
    """(start, end) of the body of the kernel whose first line is head."""
    pos = src.index(head) + len(head)
    return pos, src.index("\n}\n", pos)


def stamped(src: str, kernel: str) -> str:
    """hme.cu with the HME_STAMP markers of one kernel switched on."""
    k = KERNELS[kernel]
    pos, end = _body(src, k["head"])
    body = src[pos:end]
    if "HME_STAMP(" not in body:
        raise SystemExit(f"csrc/hme.cu: no HME_STAMP markers in "
                         f"{k['head'].strip()}")
    return src[:pos] + body.replace(
        "HME_STAMP(", f"HME_STAMP_{kernel}(") + src[end:]


def patched(src: str, nt: int, mb: int, wide, stamps: bool) -> str:
    """csrc/hme.cu with the search kernels' launch shape (nt, mb), the
    wide kernel's (wide, or as shipped when None), and the phase
    stamps."""
    if src.count(SHAPE_LINE) != 1:
        raise SystemExit(f"csrc/hme.cu: no line {SHAPE_LINE!r}")
    src = src.replace(SHAPE_LINE,
                      f"constexpr int kNT = {nt}, kMinBlocks = {mb};")
    if wide is not None:
        m = WIDE_SHAPE.search(src)
        if m is None:
            raise SystemExit("csrc/hme.cu: no kWideMinBlocks line")
        if wide[0] != nt:
            raise SystemExit(f"csrc/hme.cu launches hme_wide_kernel with kNT "
                             f"= {nt} threads, not {wide[0]}")
        mb = wide[1]
        if m.group(1):   # one bound per effort
            mb = "{%s}" % ", ".join(map(str, mb if isinstance(mb, tuple)
                                        else (mb,) * 3))
        elif isinstance(mb, tuple):
            raise SystemExit("csrc/hme.cu has one hme_wide_kernel bound for "
                             "every effort")
        line = f"constexpr int kWideMinBlocks{m.group(1) or ''} = {mb};"
        src = src[:m.start()] + line + src[m.end():]
    if not stamps:
        return src
    for kernel in KERNELS:
        src = stamped(src, kernel)
    inc = '#include "common.cuh"\n'
    defs = STAMP_DEFS % N_SLOTS
    for kernel, k in KERNELS.items():
        defs += (f"#define HME_STAMP_{kernel}(k) DSV1_STAMP({k['slot']} + "
                 "(k))\n")
    src = src.replace(inc, inc + defs, 1)
    # the shipped file's empty defaults must not undo the probe's
    src = src.replace("#ifndef HME_STAMP\n", "#if 0\n", 1)
    return src + READ_FN % N_SLOTS


ISA_SRC = r"""
#include <cstdio>
#include <cuda_runtime.h>
constexpr int kThreads = 1024, kChains = 8, kUnroll = 16;

template <int kOp>
__global__ void __launch_bounds__(kThreads, 1)
    rate_kernel(unsigned* out, long long* cyc, unsigned y, int iters) {
  unsigned a[kChains];
#pragma unroll
  for (int j = 0; j < kChains; ++j) a[j] = threadIdx.x * 0x01010101u + j;
  __syncthreads();
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int j = 0; j < kChains; ++j) {
        if (kOp == 0) a[j] = __vsadu4(a[j], y) + a[j];
        if (kOp == 1)  // the SAD added into its accumulator by the PTX op
          asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;"
              : "=r"(a[j]) : "r"(a[j]), "r"(y), "r"(a[j]));
        if (kOp == 2) a[j] = __dp4a(a[j], y, a[j]);
        if (kOp == 3) a[j] = a[j] * y + 0x9e3779b9u;
      }
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  unsigned x = 0;
#pragma unroll
  for (int j = 0; j < kChains; ++j) x ^= a[j];
  out[blockIdx.x * kThreads + threadIdx.x] = x;
  if (threadIdx.x == 0) cyc[blockIdx.x] = t1 - t0;
}

template <int kOp>
void run(const char* name, int sms, int iters, unsigned* out, long long* cyc,
         bool last) {
  long long h[1024];
  for (int rep = 0; rep < 2; ++rep)  // the second launch is read
    rate_kernel<kOp><<<sms, kThreads>>>(out, cyc, 0x03050709u, iters);
  cudaMemcpy(h, cyc, sms * sizeof(long long), cudaMemcpyDeviceToHost);
  printf("\"%s\": [", name);
  for (int b = 0; b < sms; ++b)
    printf("%s%.4f", b ? ", " : "",
           (double)kThreads * iters * kUnroll * kChains / h[b]);
  printf("]%s\n", last ? "" : ",");
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  unsigned* out;
  long long* cyc;
  cudaMalloc(&out, sms * kThreads * sizeof(unsigned));
  cudaMalloc(&cyc, sms * sizeof(long long));
  const int iters = 2048;
  printf("{\n");
  run<0>("__vsadu4(a, y) + a", sms, iters, out, cyc, false);
  run<1>("vabsdiff4.add into a", sms, iters, out, cyc, false);
  run<2>("__dp4a(a, y, a)", sms, iters, out, cyc, false);
  run<3>("a * y + c", sms, iters, out, cyc, true);
  printf("}\n");
  return cudaDeviceSynchronize() != cudaSuccess;
}
"""


def sass_opcodes(path, nvcc, least=1):
    """Per kernel of the binary at path (mangled name): the count of
    each SASS opcode that occurs at least `least` times, most first."""
    import collections
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    sass = subprocess.run([cuobjdump, "-sass", str(path)],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for fn in sass.split("Function : ")[1:]:
        ops = collections.Counter(re.findall(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
            fn))
        out[fn.split()[0]] = {op: c for op, c in ops.most_common()
                              if c >= least}
    return out


def isa_rates(nvcc_flags, nvcc, library):
    """Steps per clock per SM of each loop of ISA_SRC (median, least and
    most over the SMs), the SASS opcodes of each loop (those 128 or more
    times in a kernel: one per step of the unrolled body) and the SASS
    opcode counts of the shipped hme_wide_kernel<6> (effort 3)."""
    import statistics
    d = ROOT / "build" / "hme_probe" / "isa"
    d.mkdir(parents=True, exist_ok=True)
    (d / "isa.cu").write_text(ISA_SRC)
    flags = [f for f in nvcc_flags if f not in ("-Xcompiler", "-fPIC")]
    subprocess.run([nvcc, *flags, "-o", str(d / "isa"), str(d / "isa.cu")],
                   check=True)
    rates = json.loads(subprocess.run([str(d / "isa")], capture_output=True,
                                      text=True, check=True).stdout)
    loops = sass_opcodes(d / "isa", nvcc, 128)
    wide = {k: v for k, v in sass_opcodes(library, nvcc).items()
            if "hme_wide_kernelILi6E" in k}
    return [{"name": f"isa {op}", "steps_per_clock_per_sm": {
        "median": statistics.median(r), "min": min(r), "max": max(r)}}
        for op, r in rates.items()] + [
        {"name": "isa loop opcodes", "kernels": loops},
        {"name": "hme_wide_kernel<6> opcodes", "kernels": wide}]


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


def use_library(kb, shipped, tag=None, src=None):
    """Point the port's kernel loader at the shipped sources (tag None)
    or at a copy whose hme.cu is `src`, built at first use; returns the
    library."""
    kb._lib = None
    if tag is None:
        kb.CSRC, kb.BUILD_DIR = shipped
        return kb.lib()
    d = ROOT / "build" / "hme_probe" / tag
    csrc = d / "csrc"
    if csrc.exists():
        shutil.rmtree(csrc)
    shutil.copytree(shipped[0], csrc)
    (csrc / "hme.cu").write_text(src)
    kb.CSRC, kb.BUILD_DIR = csrc, d / "lib"
    L = kb.lib()
    if "dsv1_phase_read" in src:
        L.dsv1_phase_read.argtypes = [ctypes.c_void_p]
        L.dsv1_phase_read.restype = ctypes.c_int
    return L


def shape_of(s: str):
    """NTxMB, or NTxMB1:MB2:MB3 (per effort) -> (nt, mb or (mb1, mb2,
    mb3))."""
    nt, mb = s.split("x")
    mbs = tuple(int(x) for x in mb.split(":"))
    return int(nt), mbs if len(mbs) == 3 else mbs[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", default="base,wide",
                    help="kernels to probe: base (hme_base_kernel and the "
                         "coarse call), wide (hme_wide_kernel), isa (the "
                         "SAD instructions' issue rates)")
    ap.add_argument("--shapes", default=SHAPES, metavar="NTxMB,...",
                    help="(threads x least blocks per SM) launch shapes of "
                         "the base and coarse kernels")
    ap.add_argument("--wide-shapes", default="", metavar="NTxMB,...",
                    help="launch shapes of hme_wide_kernel (default: as "
                         "shipped)")
    ap.add_argument("--clips", default="cif,1080p,4k_cli",
                    help="golden clips whose first GOP is searched")
    ap.add_argument("--root", default=str(ROOT),
                    help="checkout whose csrc and port are probed")
    ap.add_argument("--out", default=None, help="also write JSON here")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
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
    kernels = args.kernels.split(",")
    shipped = (kb.CSRC, kb.BUILD_DIR)
    hme_src = (kb.CSRC / "hme.cu").read_text()
    tree = "" if root == ROOT else f"_{root.name}"
    use_library(kb, shipped)
    # per clip: (block, [(name, fn of the loaded library, shipped output,
    # thread blocks per call)])
    cases = {}
    searched = {"base", "wide"} & set(kernels)
    for clip in args.clips.split(",") if searched else []:
        enc, imgs = gop_images(dev, clip)
        calls = []
        if "base" in kernels:
            _fn, c = hme_calls(enc, imgs)
            (cargs,) = [a for name, a in c if name == "hme_coarse"]
            (bargs,) = [a for name, a in c if name == "hme_base"]
            nblk = bargs[0].shape[0] * bargs[5]
            calls += [("refine_coarse", lambda a=cargs: hk.refine_coarse(*a),
                       None),
                      ("refine_base_cm", lambda a=bargs: hk.refine_base_cm(*a),
                       ("base", nblk))]
        if "wide" in kernels:
            _fn, c = hme_calls(enc, imgs, 3)
            (wargs,) = [a for name, a in c if name == "hme_wide"]
            nblk = wargs[0].shape[0] * wargs[4]
            calls += [(f"refine_wide effort {e}",
                       lambda a=(*wargs[:-1], e): hk.refine_wide(*a),
                       ("wide", nblk)) for e in (1, 2, 3)]
        cases[clip] = (f"{enc.blk_w}x{enc.blk_h}",
                       [(name, fn, fn(), st) for name, fn, st in calls])
    torch.cuda.synchronize()
    base_shapes = [shape_of(s) for s in args.shapes.split(",")] \
        if "base" in kernels else [(128, 8)]
    wide_shapes = [shape_of(s) for s in args.wide_shapes.split(",") if s] \
        or [None]
    if "base" in kernels and "wide" in kernels and wide_shapes != [None]:
        raise SystemExit("give --wide-shapes with --kernels wide alone")
    rows = isa_rates(kb.NVCC_FLAGS, kb._nvcc(), kb.build()) \
        if "isa" in kernels else []
    for r in rows:
        print(json.dumps(r), flush=True)
    shapes = [(b, None) for b in base_shapes] if "base" in kernels \
        else [((128, 8), w) for w in wide_shapes] if searched else []
    for (nt, mb), wide in shapes:
        wmb = None if wide is None else (
            ":".join(map(str, wide[1])) if isinstance(wide[1], tuple)
            else str(wide[1]))
        tag = f"{nt}x{mb}" + (f"_w{wide[0]}x{wmb}" if wide else "")
        label = (f"threads={nt} min_blocks={mb}" if wide is None else
                 f"wide threads={wide[0]} min_blocks={wmb}")
        use_library(kb, shipped, tag + tree,
                    patched(hme_src, nt, mb, wide, False))
        for clip, (blk, calls) in cases.items():
            for name, fn, want, _st in calls:
                if "wide" not in name and wide is not None:
                    continue
                got = fn()
                same = all(torch.equal(a, b) for a, b in zip(
                    got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)))
                r = {"name": f"{name} {clip} {blk} {label}",
                     "ms": event_ms(fn, 20), "device_ms": queued_ms(fn, 20),
                     "equal_to_shipped": same}
                rows.append(r)
                print(json.dumps(r), flush=True)
        L = use_library(kb, shipped, tag + "_stamps" + tree,
                        patched(hme_src, nt, mb, wide, True))
        out = (ctypes.c_ulonglong * N_SLOTS)()
        for clip, (blk, calls) in cases.items():
            for name, fn, _want, st in calls:
                if st is None:
                    continue
                kernel, nblk = st
                for _ in range(2):   # the second call is read
                    fn()
                    torch.cuda.synchronize()
                    kb.check(L.dsv1_phase_read(out), "dsv1_phase_read")
                k = KERNELS[kernel]
                cyc = {p: out[k["slot"] + i] / nblk
                       for i, p in enumerate(k["markers"])}
                r = {"name": f"{name} phases {clip} {blk} {label}",
                     "cycles_per_block": cyc, "total": sum(cyc.values())}
                rows.append(r)
                print(json.dumps(r), flush=True)
    use_library(kb, shipped)
    res = {"root": str(root), "card": card,
           "seconds": time.perf_counter() - t0, "rows": rows}
    print(json.dumps({"root": str(root), "card": card,
                      "seconds": res["seconds"]}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
