"""Where the time goes inside the inverse pyramid and HZCC quantization.

    python3 tools/torch_recon_probe.py [--variants base,nopdl,...]
        [--out FILE]

Builds patched copies of `dsv1_tpu_torch/csrc/hzcc.cu` and `recon.cu`
into small libraries under `build/recon_probe/` (one nvcc per variant,
all started together), swaps each in for the port's library, and times
the recon units on golden frames at 1080p, 3840x2160 and CIF
(`chip_smoke.recon_frames`, stability flags from seed 5): the recon of
a luma P plane and of a luma I plane into the frame image
(`sbt.inv_sbt_recon`) and `hzcc.encode_plane_core` on P planes, quant
300 (luma and chroma at 1080p and CIF, CIF also as a batch of C = 4,
luma at 4K). For each: the device time per call with the host out of
the way (a CUDA graph of 20 calls, replayed 10 times), the union of the
call's kernel intervals (torch.profiler), and each kernel's launches and
mean duration per call. A variant may be named more than once, so that
two variants can be timed in turns. Variants (each times the inverse's
units, the quantizer's, or both):

- base: the sources as they are (both);
- nopdl: no programmatic dependent launch, so each inverse kernel's
  duration is its own work and not its wait for the one before;
- stageonly: nopdl, and the coarse stage stops after staging its corner;
- empty: nopdl, and the coarse stage returns at once (a block's fixed
  cost);
- lr1, lr4: a thread of the tiled inverse kernels takes 1 or 4 quad
  rows (2 shipped);
- c512: the coarse stage on 512 threads (1024 shipped);
- warp256: the coarse levels of at most 256 quads on one warp (64
  shipped);
- lb8: the last inverse kernel held to 8 blocks an SM (32 registers);
- flat: the Haar quad without branches between its loads (every LL
  neighbour loaded and both nudges computed, each kept where it
  applies);
- stamps: clock64() on thread 0 of the coarse stage's block and of the
  middle block of the last and the tiled launches at their phases
  (staged corner, each level; bands loaded, the wait, the upper level,
  the lower level, the stores), read after one more call of each unit
  (cycles from the block's start; `STAMPS` names the slots);
  flatstamps the same on flat;
- nochain: the quantizer without its segment chain (its loads, setup
  and write-back stores);
- q4, q1: the quantizer at 4 or 1 positions a thread on every batch
  (shipped: 4 from `kMinTiles4` tiles of 4 positions, else 1);
- adj, adj16: 4 neighbouring positions a thread on every batch, with
  scalar loads and stores, or with 16-byte ones of the coefficients and
  the written-back grid where the row allows (shipped: 32 columns
  apart).

A variant that removes work gives wrong outputs: its times say what that
work costs, nothing else. Needs a CUDA device.
"""

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

R, H = "recon.cu", "hzcc.cu"
NOPDL = (R, "cfg.numAttrs = dep ? 1 : 0;", "cfg.numAttrs = 0;")
COARSE_LEVELS = "  int in = 0, k = 0, i = top;\n"
Q_FORK = "  if (tiles4 >= kMinTiles4)\n"
Q_ADJ = [(H, "const int x0 = tx0 + (threadIdx.x >> 5) * 32 * kQx + "
          "(threadIdx.x & 31);", "const int x0 = tx0 + threadIdx.x * kQx;"),
         (H, Q_FORK, "  if (true)\n")]
Q_LOAD = ("#pragma unroll\n  for (int j = 0; j < kQx; ++j)\n"
          "    v[j] = live && x0 + 32 * j < W ? __ldg(crow + x0 + 32 * j) "
          ": 0;\n")
Q_STORE = ("#pragma unroll\n  for (int j = 0; j < kQx; ++j)\n"
           "    if (x0 + 32 * j < W) wrow[x0 + 32 * j] = v[j];\n")
VEC = ("kQx == 4 && x0 + 4 <= W && "
       "((uintptr_t)(crow + x0) & 15) == 0 && "
       "((uintptr_t)(work + b * wbatch + (int64_t)y * W + x0) & 15) == 0")
Q_VEC = [(H, Q_LOAD,
          f"  if (live && {VEC}) {{\n"
          "    const int4 t = __ldg(reinterpret_cast<const int4*>(crow + x0));"
          "\n    const int tv[4] = {t.x, t.y, t.z, t.w};\n"
          "    for (int j = 0; j < kQx; ++j) v[j] = tv[j];\n"
          "  } else\n" + Q_LOAD.replace("#pragma unroll\n", "")),
         (H, Q_STORE,
          f"  if ({VEC}) {{\n    int4 t;\n    int* tv = &t.x;\n"
          "    for (int j = 0; j < kQx; ++j) tv[j] = v[j];\n"
          "    *reinterpret_cast<int4*>(wrow + x0) = t;\n    return;\n"
          "  }\n" + Q_STORE)]
# every position index of the quantizer, 32 j columns apart, made j
Q_NEAR = [(H, "32 * j", "j")]
STAMP_DEFS = """
__device__ long long g_stamp[64];
#define STAMP(k) do { if (threadIdx.x == 0 && threadIdx.y == 0 && \\
    blockIdx.x == gridDim.x / 2 && blockIdx.y == gridDim.y / 2 && \\
    blockIdx.z == 0) g_stamp[k] = clock64(); } while (0)
extern "C" int dsv1_stamps(long long* h, int reset) {
  if (reset) {
    static const long long z[64] = {0};
    return (int)cudaMemcpyToSymbol(g_stamp, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(h, g_stamp, sizeof(g_stamp));
}
"""
STAMP_PATCHES = [
    (R, '#include "common.cuh"\n', '#include "common.cuh"\n' + STAMP_DEFS),
    (R, "  const int b = blockIdx.x, tid = threadIdx.x;\n"
     "  const int warp = tid >> 5, lane = tid & 31;\n",
     "  const int b = blockIdx.x, tid = threadIdx.x;\n"
     "  const int warp = tid >> 5, lane = tid & 31;\n  STAMP(0);\n"),
    (R, "  copy_wait();\n  __syncthreads();\n",
     "  copy_wait();\n  __syncthreads();\n  STAMP(1);\n"),
    (R, "      __syncwarp();\n    }\n    in = k ? buf1 : buf0;\n  }\n"
     "  __syncthreads();\n",
     "      __syncwarp();\n      STAMP(2 + top - i);\n    }\n"
     "    in = k ? buf1 : buf0;\n  }\n  __syncthreads();\n  STAMP(20);\n"),
    (R, "    if (i > lo) __syncthreads();\n    in = k ? buf1 : buf0;\n  }\n}\n",
     "    if (i > lo) __syncthreads();\n    STAMP(2 + top - i);\n"
     "    in = k ? buf1 : buf0;\n  }\n  __syncthreads();\n  STAMP(21);\n}\n"),
    (R, "  uint8_t pr[kLR][4];\n", "  uint8_t pr[kLR][4];\n  STAMP(32);\n"),
    (R, "  dep_wait();  // the level above has written ll\n",
     "  STAMP(i > 1 ? 49 : 33);\n  dep_wait();\n  STAMP(i > 1 ? 50 : 34);\n"),
    (R, "  tile_upper(P, b, 1, has2, ll + b * lbatch, lls, T1, T2, qy0, qx0, "
     "tid, pre);\n",
     "  tile_upper(P, b, 1, has2, ll + b * lbatch, lls, T1, T2, qy0, qx0, "
     "tid, pre);\n  STAMP(35);\n"),
    (R, "  if (E.mode == 0) {\n    int* out = static_cast<int*>(E.out) + "
     "b * E.obatch;\n",
     "  STAMP(36);\n  if (E.mode == 0) {\n    int* out = "
     "static_cast<int*>(E.out) + b * E.obatch;\n"),
    (R, "            (uint16_t)(px[r][2 * dy] | px[r][2 * dy + 1] << 8);\n"
     "    }\n    return;\n",
     "            (uint16_t)(px[r][2 * dy] | px[r][2 * dy + 1] << 8);\n"
     "    }\n    STAMP(37);\n    return;\n"),
    (R, "      LH[r] = HL[r] = HH[r] = 0;\n      if (qy < d.ch",
     "      STAMP(48);\n      LH[r] = HL[r] = HH[r] = 0;\n      if (qy < d.ch"),
    (R, "  tile_upper(P, b, i, has_up, ll + b * lbatch, lls, T1, T2, qy0, "
     "qx0, tid,\n             pre);\n",
     "  tile_upper(P, b, i, has_up, ll + b * lbatch, lls, T1, T2, qy0, "
     "qx0, tid,\n             pre);\n  STAMP(51);\n"),
    (R, "      if (y < d.hs && x < d.ws) out[(int64_t)y * d.ws + x] = o[j];\n"
     "    }\n  }\n}\n",
     "      if (y < d.hs && x < d.ws) out[(int64_t)y * d.ws + x] = o[j];\n"
     "    }\n  }\n  STAMP(52);\n}\n"),
]
FLAT = [
    (R, "  if (mx3 == mn3) return band;\n  const int t = round4(lo - hi);\n"
     "  const int nd = round2(min(max(t, mx3), mn3) - band * 2);\n"
     "  return band + clampi(nd, -hqp, hqp);\n",
     "  const int t = round4(lo - hi);\n"
     "  const int nd = round2(min(max(t, mx3), mn3) - band * 2);\n"
     "  return mx3 == mn3 ? band : band + clampi(nd, -hqp, hqp);\n"),
    (R, "    if (qx >= 1 && qx <= d.fw - 1 && qy <= d.fh - 1)\n"
     "      LH = nudge(LL, L(qy, qx - 1), L(qy, qx + 1), LH, hqp);\n"
     "    if (qy >= 1 && qy <= d.fh - 1 && qx <= d.fw - 1)\n"
     "      HL = nudge(LL, L(qy - 1, qx), L(qy + 1, qx), HL, hqp);\n",
     "    const int w = L(qy, qx > 0 ? qx - 1 : qx), e = L(qy, qx + 1);\n"
     "    const int n = L(qy > 0 ? qy - 1 : qy, qx), s = L(qy + 1, qx);\n"
     "    const int lh = nudge(LL, w, e, LH, hqp);\n"
     "    const int hl = nudge(LL, n, s, HL, hqp);\n"
     "    if (qx >= 1 && qx <= d.fw - 1 && qy <= d.fh - 1) LH = lh;\n"
     "    if (qy >= 1 && qy <= d.fh - 1 && qx <= d.fw - 1) HL = hl;\n"),
]
# slot: what thread 0 of the stamped block has done (cycles from the
# slot that starts its kernel: 0, 32 or 48)
STAMPS = {1: "coarse: corner staged", 20: "coarse: warp levels done",
          21: "coarse: end", 33: "last: bands, pred loaded",
          34: "last: wait over", 35: "last: level 2 in shared memory",
          36: "last: level 1 computed", 37: "last: stored (inner tile)",
          49: "tile: bands loaded", 50: "tile: wait over",
          51: "tile: upper level in shared memory", 52: "tile: end"}
STAMPS.update({2 + k: f"coarse: level top - {k} done" for k in range(18)})
# name: (what it times: "inv", "quant" or "all", patches)
VARIANTS = {
    "base": ("all", []),
    "nopdl": ("inv", [NOPDL]),
    "stageonly": ("inv", [NOPDL, (R, COARSE_LEVELS,
                                  COARSE_LEVELS + "  if (top > 0) return;\n")]),
    "empty": ("inv", [NOPDL, (R, "  dep_wait();\n  dep_launch();\n"
                              "  const int b = blockIdx.x, tid = threadIdx.x;\n",
                              "  dep_wait();\n  dep_launch();\n"
                              "  if (P.H > 0) return;\n"
                              "  const int b = blockIdx.x, tid = threadIdx.x;"
                              "\n")]),
    "lr1": ("inv", [(R, "kLR = 2,", "kLR = 1,")]),
    "lr4": ("inv", [(R, "kLR = 2,", "kLR = 4,")]),
    "c512": ("inv", [(R, "kCoarseThreads = 1024;", "kCoarseThreads = 512;")]),
    "warp256": ("inv", [(R, "if (nq > 64) break;", "if (nq > 256) break;")]),
    "flat": ("inv", FLAT),
    "stamps": ("inv", STAMP_PATCHES),
    "flatstamps": ("inv", FLAT + STAMP_PATCHES),
    "lb8": ("inv", [(R, "__global__ void __launch_bounds__(kThreads)\n"
                     "inv_last_kernel(",
                     "__global__ void __launch_bounds__(kThreads, 8)\n"
                     "inv_last_kernel(")]),
    "nochain": ("quant", [(H, "  for (int t = 0; t < nseg; ++t) {",
                           "  for (int t = 0; t < 0 * nseg; ++t) {")]),
    "q4": ("quant", [(H, Q_FORK, "  if (true)\n")]),
    "q1": ("quant", [(H, Q_FORK, "  if (false)\n")]),
    "adj": ("quant", Q_ADJ + Q_NEAR),
    "adj16": ("quant", Q_ADJ + Q_VEC + Q_NEAR),
}


def build(names):
    """One library per variant from the patched sources."""
    from dsv1_tpu_torch.kernels import build as kb
    out = ROOT / "build" / "recon_probe"
    procs = {}
    for name in dict.fromkeys(names):
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "common.cuh").write_text((kb.CSRC / "common.cuh").read_text())
        for f in (H, R):
            s = (kb.CSRC / f).read_text()
            for ff, old, new in VARIANTS[name][1]:
                if ff == f:
                    if old not in s:
                        raise SystemExit(f"variant {name}: {old!r} is not in "
                                         f"{f}")
                    s = s.replace(old, new)
            (d / f).write_text(s)
        procs[name] = subprocess.Popen(
            [kb._nvcc(), *kb.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
             str(d / H), str(d / R)])
    for name, p in procs.items():
        if p.wait():
            print(f"nvcc failed on variant {name}: skipped", file=sys.stderr)
    libs = {}
    for name in procs:
        if procs[name].returncode:
            continue
        L = ctypes.CDLL(str(out / name / "lib.so"))
        for fn in ("dsv1_hzcc_quant", "dsv1_inv_sbt"):
            getattr(L, fn).argtypes = getattr(kb.lib(), fn).argtypes
            getattr(L, fn).restype = ctypes.c_int
        libs[name] = L
    return libs


def profile(fn, reps=30):
    """(union of kernel intervals per call in us, {kernel: [launches per
    call, mean us]}) over reps calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof

    import chip_smoke as cs
    fn()
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU,
                          ProfilerActivity.CUDA]) as p:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per, iv = {}, []
    for e in p.events():
        if e.device_type != DeviceType.CUDA \
                or e.name.startswith(("Memcpy", "Memset")):
            continue
        m = re.search(r"(\w+_kernel)", e.name)
        d = per.setdefault(m.group(1) if m else e.name[:40], [0, 0.0])
        d[0] += 1
        d[1] += e.time_range.end - e.time_range.start
        iv.append((e.time_range.start, e.time_range.end))
    return cs.union_us(iv) / reps, {k: [v[0] / reps, v[1] / v[0]]
                                    for k, v in per.items()}


def graph_us(fn):
    """Device time per call of fn in a CUDA graph (us)."""
    from torch_kernel_times import graph_ms
    return graph_ms(fn) * 1e3


def stamps(L, fn):
    """{slot name: cycles} of one call of fn in the stamps variant."""
    import torch
    buf = (ctypes.c_longlong * 64)()
    torch.cuda.synchronize()
    if L.dsv1_stamps(buf, 1):
        raise SystemExit("stamps: reset failed")
    fn()
    torch.cuda.synchronize()
    if L.dsv1_stamps(buf, 0):
        raise SystemExit("stamps: read failed")
    out = {}
    for k, name in sorted(STAMPS.items()):
        t0 = buf[0 if k < 32 else 32 if k < 48 else 48]
        if buf[k] and t0:
            out[f"{k} {name}"] = buf[k] - t0
    return out


def units(dev):
    """{name: (kind, fn)} of the recon units (see the module docstring)."""
    import torch

    import chip_smoke as cs
    import dsv1_tpu_torch as dt
    from dsv1_tpu_torch.ops import bmc, hzcc, sbt
    from dsv1_tpu_torch.utils import golden as g
    out = {}
    for clip, C in (("1080p", 1), ("4k_cli", 1), ("cif", 1), ("cif", 4)):
        layout, dims, tables, img, preds, stable = cs.recon_frames(
            dev, dt.SUBSAMP_420, g.clip_frames(clip)[1], C, 5)
        res = bmc.residual_in(img, layout, dims, preds)
        tag = clip if C == 1 else f"{clip} C{C}"
        for c in (0, 1) if clip != "4k_cli" else (0,):
            coefs = sbt.fwd_sbt(res[c], True)
            out[f"quant P {tag}" + (" chroma" if c else "")] = (
                "quant", lambda k=coefs, s=stable, t=tables[c], c=c:
                hzcc.encode_plane_core(k, 300, True, c, s, t))
        if C > 1:
            continue
        _qv, wb = hzcc.encode_plane_core(sbt.fwd_sbt(res[0], True), 300,
                                         True, 0, stable, tables[0])
        icoefs = sbt.fwd_sbt(bmc.residual_in(img, layout, dims, None)[0],
                             False)
        _qv, iwb = hzcc.encode_plane_core(icoefs, 300, False, 0, stable,
                                          tables[0])
        rec = torch.zeros_like(img)
        out[f"inv P {clip}"] = ("inv", lambda w=wb, r=rec, lay=layout,
                                p=preds: sbt.inv_sbt_recon(
                                    w, 300, True, True, r, lay, 0, p[0]))
        out[f"inv I {clip}"] = ("inv", lambda w=iwb, r=rec, lay=layout:
                                sbt.inv_sbt_recon(w, 300, False, True, r,
                                                  lay, 0))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated, a name may repeat")
    ap.add_argument("--out", default=None, help="also write JSON here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_recon_probe: needs a CUDA device")
    from dsv1_tpu_torch.kernels import build as kb
    names = args.variants.split(",")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    work = units(dev)
    libs = build(names)
    res = {"card": card, "runs": []}
    for name in names:
        if name not in libs:
            continue
        kb._lib = libs[name]
        kind = VARIANTS[name][0]
        rows = {}
        for u, (k, fn) in work.items():
            if kind not in ("all", k):
                continue
            union, per = profile(fn)
            rows[u] = {"graph_us": graph_us(fn), "union_us": union,
                       "kernels": per}
        if name.endswith("stamps"):
            for u, (k, fn) in work.items():
                if k == "inv":
                    rows[u]["stamps"] = stamps(libs[name], fn)
        res["runs"].append({"variant": name, **rows})
        print(json.dumps(res["runs"][-1]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
