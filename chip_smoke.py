#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits
non-zero:

1. device  — requires CUDA; prints the card's name, power limit and
   maximum SM clock (the integer peak of the bounds below).
2. build   — compiles dsv1_tpu_torch/csrc/*.cu with nvcc (sm_90a), one
   process per source, all started together.
3. kernels — each CUDA kernel against its plain PyTorch version on the
   same inputs, at the main path's shapes: on a 1080p GOP (one GOP's 11
   P-frame pairs; the arguments `hme_batch` itself passes) `hme_refine`
   (`hme_kernels.refine_coarse`, one C call for every coarse level and
   the level-0 candidates) and `hme_base`; `mc` (`bmc.compensate_frame`,
   one call per frame, all three planes) on a P frame's HME field and on
   a fuzzed field; on a 3840x2160 GOP `hme_base` again (the work of the
   JAX package's banded 4K kernel) and `mc` on both fields; `haar_fwd`
   (`sbt.haar_fwd_pyramid`, one call per plane, every Haar level) on a
   1080p luma P plane and I plane, a 4K luma P plane and a few odd
   shapes. The HME kernels are also held to their plain versions (errors
   only) on a 1918x1078 clip, with the encoder's candidates and with
   fuzzed ones far past the border clamps. Then the recon chain's
   kernels (`recon_rows`): `residual_in` (`bmc.residual_in`, the
   prologue of a frame's three planes), `b4t_fwd` (`sbt.b4t_fwd`, the
   intra level 1), `hzcc_quant` and `hzcc_dequant`
   (`hzcc.encode_plane_core`, `dequant_plane_grid`) and `inv_sbt`
   (`sbt.inv_sbt`, and `inv_sbt_recon` with the recon epilogue into the
   frame image), stage by stage on CIF, 1080p and 4K golden frames, I
   and P, every plane, B = 1 and batched with a quant per frame, fuzzed
   coefficients, 100x84 (aliasing bands), 98x82, 4:2:2 and 4:1:1
   chroma, odd level sizes at several depths (102x86 and 1918x1078, C =
   4 with a quant per plane, int32 stability maps at 1918x1078) and the
   inverse's largest coarse stage (1776x1760); each timed on its 1080p
   unit (a luma plane; the prologue a frame), with 4K and CIF beside it;
   and `hzcc_compact` (`hzcc.compact_exact`, the exact compaction of an
   overflowed chunk) on a 12-frame chunk at 1080p, at 4K with both caps
   overflowed, at CIF (4 GOPs) and on one UHD intra frame's row (gop 0's
   chunk at UHD, I cap overflowed), timed at 4K and on the intra row
   beside the host route it replaced (`compact_rows`). Equality is exact
   (tolerance 0: the codec is integer-only). Each kernel is timed with
   CUDA events after warm-up, wrappers included, and with torch.profiler (device
   only: the union of each call's kernel intervals). Each row gets the least time the card could take
   for the same work (bytes over 3.35 TB/s, integer operations over 132
   SMs x 64 INT32 lanes x the SM clock, the larger of the two). The HME
   rows count a 4-pixel SAD as one instruction (VABSDIFF4.U8.ACC, which
   issues at the INT32 rate) and every other per-pixel u8 operation
   four pixels to an instruction, as sm_90a runs them, and also give
   the bound of the scalar count and their bytes bound alone.
4. edges   — small clips with partial blocks, 4:4:4, 4:2:2 and 4:1:1
   chroma, per-frame and GOP-granular ABR, encoded and decoded on the
   GPU and on the CPU (plain versions): the same bytes; and `mc` against
   its plain version on 4:2:2 and 4:1:1 frames (96x80 and 1920x1080,
   fuzzed fields), which joins the `mc` row's error.
5. slice   — the CIF and 1080p golden clips (gop 12, qp 85 CRF, 24
   frames) through `encode_stream_gops` and `decode_stream_gops`; the
   1080p encode and decode again (outside the counts) for their kernels
   per frame and device busy share (`run_metrics`).
6. cli     — the CLI's default path (per-frame ABR, auto bitrate, gop
   12): `dsv1_tpu_torch.cli.main` e then d on the CIF clip (24 frames)
   and on a 3840x2160 clip (13 frames), through files; then
   `1080p_gopabr_cli` (37 frames, -gopabr1: GOP-granular ABR; the GOP
   it calibrates on, if any GOP fits its caps, runs its recon chain
   twice).
7. sequential — first the HME kernels against their plain versions on
   the B = 1 arguments the sequential `Encoder` passes for a 1080p P
   frame (errors, CUDA-event ms, device-only ms); then two 1920x1080
   clips through the CLI and files: `1080p_seq_cli` (13 frames, -gopar0:
   per-frame ABR at gop 12 on the sequential `Encoder`) decoded three
   ways (the CLI's default decode, -drawinfo7 through the sequential
   `Decoder`, and `Decoder().decode_stream` through the API), and
   `1080p_gop0_cli` (12 frames, -gop0 -rc_mode1: intra only through
   `encode_stream_gops`) with its decode; then `4k_gop0`: 4k_cli's first
   4 frames at -gop0 -rc_mode1, each overflowing the I cap, through
   `encode_stream_gops` (the exact compaction, `hzcc_compact`'s launches
   counted from that run alone) and through the sequential `Encoder`
   (the dense read): the same bytes.
8. effort  — the wider level-0 motion search (-effort1..3): first kernel
   #2 at level 0 (`hme_kernels.refine_level`, `hme_refine_level0`) and
   `hme_wide` (`hme_kernels.refine_wide`) against their plain versions
   on the first GOP of a 1920x1080 and a 3840x2160 clip at effort 3, on
   `hme_batch`'s own arguments and on edge inputs (candidates at the
   +-64 validity limits, a `pre` at the four edges of the 9-point
   search), `hme_wide` at efforts 1, 2 and 3, and both again on the
   B = 1 arguments the sequential Encoder passes at effort 2 (`hme_wide`
   at every effort there); `hme_wide` also at every effort on CIF's
   16x16 blocks and on a 1918x1078 clip (each on its own and an edge
   `pre`), and on the 1080p GOP's images cut 48 rows around the frame,
   so that windows read the cut image's first and last chunk; both
   decoders' last frame (`Decoder`, `iter_decode_gops`) of a CRF
   effort-2 encode of `1080p_effort_seq_cli`'s clip held to the
   Encoder's reconstruction of it; then three clips through the CLI and
   files: `1080p_effort_cli` and `4k_effort_cli` (13 frames, -effort3
   at the CLI's defaults: per-frame ABR on the GOP-parallel encoder) and
   `1080p_effort_seq_cli` (13 frames, -gopar0 -effort2: the sequential
   Encoder), each decoded by the CLI, the last also by the `Decoder`
   API.
9. batches — several GOPs through each launch: first `mc` on the P
   frames of one frame index of a chunk (C = 4 GOPs at CIF, C = 2 at
   1080p; HME and fuzzed fields) and `haar_fwd` on C planes (P and I)
   in one call, each against its plain version and against C single
   calls, timed beside the C = 1 call; then `cif_batch` (52 frames,
   gop 12, qp 85 CRF through `encode_stream_gops` at its default: 4
   GOPs a chunk, then a tail GOP of 4 frames padded to a chunk; every P
   call carries 4 frames) with its frames/s, kernels per encoded frame
   and device busy share (tools/torch_profile.py) at the default and at
   gops_per_device=1, whose stream must be the same bytes, and its
   decode's;
   `cif_batch_cut` (40 frames, stable_refresh 4, a cut in the second
   GOP: GOPs start from carried stability states, and a frame index
   splits into P and intra frames); `1080p_gopabr_batch` (37 frames,
   -gopabr1's settings at 2 GOPs a chunk: its own golden, not
   `1080p_gopabr_cli`'s); and `cif_shards`: `cif_batch`'s clip through
   `encode_stream_multihost` with 3 shards, then through
   `run_distributed_shard` in 2 processes on this card (gloo on
   127.0.0.1, tools/torch_shard_worker.py), each muxed stream equal to
   `cif_batch`'s golden.
10. mesh   — the batched decode, GOP meshes, column tiles and the gop x
   tile encode, on mesh entries that share the one card (the split, the
   carried state and the bytes are checked; scaling is not): first the
   level-0 search at the +-64 limit (a 64-pixel pan at 64x64 blocks and
   6 levels) through `hme_batch` on the card against the port on the
   CPU at effort 0 and 2, and kernels #3 (`hme_base`) and #2 at level 0
   (`hme_refine_level0`), `hme_wide` and the coarse call against their
   plain versions with candidates and `pre` at the limit; `cif_batch`'s
   stream decoded 4 chains a launch (the JAX rule) with its decode
   frames/s and `mc` launches per decoded frame; over
   gop_mesh(["cuda:0"] * 2) `cif_batch` encoded and decoded, the `1080p`
   CRF clip, and `1080p_gopabr_batch`'s clip at -gopabr1's settings at
   1 GOP a device (the bytes of 2 GOPs a chunk); `fwd_sbt_tiled`,
   `inv_sbt_tiled` and `encode_plane_tiled` on tile_mesh(["cuda:0"] * 4)
   on 1080p luma I and P planes against the untiled functions, each
   tiled Haar level on kernel #5 with its launches predicted;
   gop_tile_mesh(1, 4) on the `1080p` clip and (2, 2) on `cif`. Each
   stream and decode against its golden; about a minute.
Phases 5 to 10 are main paths: each path's streams and decodes must
hash to dsv1_tpu_torch/data/golden.json (written from the JAX package
by tools/torch_golden.py), and the kernels' launch counts are set to 0
before each path and read after it; every kernel of a path must have
launched on it (`mc`, `hme_refine`, `hme_base` and `haar_fwd` on the
slice, CLI and sequential encodes, `hme_wide` in place of `hme_base` on
the effort encodes, with `hme_refine_level0`: the level-0 launches,
also counted in `hme_refine`; `haar_fwd` and neither `mc` nor HME on
the gop-0 encode, `mc` on the decoders; `residual_in`, `b4t_fwd`,
`hzcc_quant` and `inv_sbt` on the encodes, not `inv_sbt` at gop 0,
`hzcc_dequant` and `inv_sbt` on the decoders), and each count must
equal the count
predicted from what the path did (`dsv1_tpu_torch/utils/stats.py`
STATS: calls of the encode core on intra and on P frames, each a frame
or the frames of one type at one frame index of a chunk, HME calls at
effort 0 and above, one a chunk, MC calls and reconstructions of the
decoders: a frame index of a chunk of chains, or a picture of the
sequential `Decoder`)
and from each wrapper's launches per call at the clip's geometry
(`predict_launches`). Each encode prints its `overflow_redos`: the
chunks of GOPs (gop 0: chunks of frames; sequential: frames) whose
compaction overflowed and were packed from every symbol of their planes
(the GOP path: `hzcc_compact`'s lists, three launches a chunk; gop 0
and sequential: the dense planes).

The line before the card's line lists every kernel with its launches
summed over the main paths of phases 5 to 10 (4k_cli's level 0 on the
`hme_base_banded` row), its error and times; the last line is
{"ok": true, "device": {...}}.
"""

import hashlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ENCODE_REPS = 2            # the first encode/decode of a clip warms up
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
INT32_LANES = 132 * 64     # SMs x INT32 lanes per SM
U8_PER_WORD = 4            # u8 pixels per SIMD integer instruction
SAD_OPS = 2                # scalar ops a SAD pixel: |a - b|, then the add
# INT32 issue slots of a 4-pixel SAD: one VABSDIFF4.U8.ACC (|a - b| of
# four bytes and their sum into an accumulator), which issues at IMAD's
# rate (tools/torch_hme_probe.py --kernels isa)
SAD_SLOTS = 1
HP_PIXELS = 14 * 14        # a half-pel SAD window
FILTER_OPS = 9             # a filtered sample: 4 taps, rounding, clamp
# `hme_refine_level0` counts `hme_refine`'s level-0 launches apart
KERNELS = ("mc", "hme_refine", "hme_refine_level0", "hme_base", "hme_wide",
           "haar_fwd", "residual_in", "b4t_fwd", "hzcc_quant",
           "hzcc_dequant", "inv_sbt", "hzcc_compact")
# the recon chain's kernels of an encode (csrc/recon.cu, csrc/hzcc.cu)
# and of a decode
ENC_RECON = ("residual_in", "b4t_fwd", "hzcc_quant", "inv_sbt")
DEC_RECON = ("hzcc_dequant", "inv_sbt")
# the kernels of an encode at effort 0 and at effort 1..3, of a decode
BASE_PATH = ("mc", "hme_refine", "hme_base", "haar_fwd") + ENC_RECON
WIDE_PATH = ("mc", "hme_refine", "hme_refine_level0", "hme_wide",
             "haar_fwd") + ENC_RECON
DECODE_PATH = ("mc",) + DEC_RECON
# a gop x tile encode: the tiled transforms run their B4T and inverse
# levels eager (parallel/tile.py), and on the kernels only for planes
# too narrow to split (`tiled_whole`), which predict_launches counts
TILE_PATH = tuple(k for k in BASE_PATH if k not in ("b4t_fwd", "inv_sbt"))
SLICE_CLIPS = ("cif", "1080p")     # encode_stream_gops, CRF
# the CLI at its defaults (per-frame ABR), then GOP-granular ABR
CLI_CLIPS = ("cif_cli", "4k_cli", "1080p_gopabr_cli")
GOPABR_CLIP = "1080p_gopabr_cli"
SEQ_CLIP, GOP0_CLIP = "1080p_seq_cli", "1080p_gop0_cli"
# 4k_cli's first frames at gop 0 (one frame a chunk, each overflowing)
UHD_GOP0_FRAMES = 4
# the CLI at -effort3 (per-frame ABR, 1080p and 4K), -gopar0 -effort2
EFFORT_CLIPS = ("1080p_effort_cli", "4k_effort_cli", "1080p_effort_seq_cli")
EFFORT_SEQ_CLIP = "1080p_effort_seq_cli"
# several GOPs a launch (encode_stream_gops at its default chunk), a cut
# with carried stability states, GOP-granular ABR at 2 GOPs a chunk
BATCH_CLIP, CUT_CLIP = "cif_batch", "cif_batch_cut"
GOPABR_BATCH_CLIP = "1080p_gopabr_batch"
SHARD_TIMEOUT_S = 300      # each shard process of phase 9
ROW_KEYS = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")


def emit(obj):
    print(json.dumps(obj), flush=True)


def sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches, after one warm-up."""
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


def max_abs_err(a, b) -> int:
    """Largest |a - b| over tensors (or tuples of tensors) of equal
    shapes."""
    import torch
    if isinstance(a, (tuple, list)):
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    if a.shape != b.shape:
        raise AssertionError(f"shape mismatch {tuple(a.shape)} vs "
                             f"{tuple(b.shape)}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def smi_query(fields: str, units: bool = True) -> str:
    fmt = "csv,noheader" + ("" if units else ",nounits")
    return subprocess.run(["nvidia-smi", f"--query-gpu={fields}",
                           f"--format={fmt}"], capture_output=True,
                          text=True, check=True).stdout.strip() \
        .splitlines()[0]


def phase_device():
    import torch
    smi = smi_query("name,power.limit")
    clock_mhz = float(smi_query("clocks.max.sm", units=False))
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvidia_smi": smi,
          "max_sm_clock_mhz": clock_mhz})
    return smi, clock_mhz * 1e6


def phase_build():
    from dsv1_tpu_torch.kernels import build as kb
    t0 = time.perf_counter()
    path = kb.build()
    kb.lib()
    emit({"phase": "build", "library": str(path.relative_to(ROOT)),
          "nvcc_seconds": kb.BUILD_SECONDS,
          "seconds": time.perf_counter() - t0})


class Bound:
    """The least time the card could take for a kernel's work: its bytes
    (each input read once, each output written once) over the HBM rate,
    or its integer operations over the INT32 peak, whichever is larger."""

    def __init__(self, clock_hz: float):
        self.ops_per_s = INT32_LANES * clock_hz

    def __call__(self, nbytes: float, ops: float):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / self.ops_per_s * 1e3
        return (max(t_bytes, t_ops),
                "bytes" if t_bytes >= t_ops else "operations")


def _plane_bytes(src, lay):
    """Bytes of the (B, EH, S) luma planes a search reads from the (B, n)
    flat images src of layout lay."""
    p = lay.planes[0]
    return src.shape[0] * (p.h + 2 * p.ext) * p.stride


def _search_area(w, h, nbh_l, nb, BW, BH):
    """Pixels inside the frame over all blocks of a level."""
    return min(nbh_l * BW, w) * min((nb // nbh_l) * BH, h)


def _half_pel(blocks, rh):
    """(SAD pixels, other scalar ops) of the half-pel stage of `blocks`
    in-frame blocks on the +-rh grid ((2 rh + 1)^2 - 1 points, 8 at rh
    1): a 14x14 SAD per point; per block FILTER_OPS for each sample of
    the three filtered planes (horizontal, vertical, diagonal) over the
    (14 + rh)^2 samples the grid's windows cover, each plane filtered
    once, and 20 ops per window pixel for the two texture statistics."""
    points = (2 * rh + 1) ** 2 - 1
    return (blocks * points * HP_PIXELS,
            blocks * (3 * (14 + rh) ** 2 * FILTER_OPS + 20 * HP_PIXELS))


def work_hme_coarse(cargs):
    """(bytes, SAD pixels, other ops) of the coarse levels of one GOP,
    summed over levels: per level both planes, candidates and outputs;
    per block pixel a SAD for each of NC candidates (1 at the top level,
    else 6) and 9 refine points."""
    src, _ref, lays, BW, BH, nbh, nbv, levels = cargs
    nbytes = sad = 0
    for level in range(levels, 0, -1):
        p = lays[level].planes[0]
        step = 1 << level
        nbh_l = -(-nbh // step)
        nb = nbh_l * -(-nbv // step)
        B, NC = src[level].shape[0], 1 if level == levels else 6
        nbytes += 2 * _plane_bytes(src[level], lays[level]) \
            + B * nb * (2 * NC + 3) * 4
        sad += B * _search_area(p.w, p.h, nbh_l, nb, BW, BH) * (NC + 9)
    return nbytes, sad, 0


def work_hme_base(args):
    """(bytes, SAD pixels, other ops) of one level-0 call: as one coarse
    level, plus 28 ops per block pixel for its statistics (sums, squares,
    gradients, zero-MV window, intra test, quadrant metric) and, per
    in-frame block, the half-pel stage on the 8 neighbours
    (`_half_pel`)."""
    src, _ref, lay, cm, nbh_l, nb, BW, BH = args
    w, h = lay.planes[0].w, lay.planes[0].h
    B, NC = src.shape[0], cm.shape[-1] // 2
    nbv_l = nb // nbh_l
    inframe = min(nbh_l, -(-w // BW)) * min(nbv_l, -(-h // BH))
    nbytes = 2 * _plane_bytes(src, lay) + B * nb * (2 * NC + 6) * 4
    area = B * _search_area(w, h, nbh_l, nb, BW, BH)
    hp_sad, hp_ops = _half_pel(B * inframe, 1)
    return nbytes, area * (NC + 9) + hp_sad, area * 28 + hp_ops


def work_hme_level(args):
    """(bytes, SAD pixels, other ops) of one `refine_level` call: both
    planes, the candidates and the outputs; per block pixel a SAD for
    each of NC candidates and 9 refine points."""
    src, _ref, lay, cmx, _cmy, nbh_l, nb, BW, BH, _level = args
    w, h = lay.planes[0].w, lay.planes[0].h
    B, NC = src.shape[0], cmx.shape[-1]
    nbytes = 2 * _plane_bytes(src, lay) + B * nb * (2 * NC + 3) * 4
    return nbytes, B * _search_area(w, h, nbh_l, nb, BW, BH) * (NC + 9), 0


def work_hme_wide(wargs):
    """(bytes, SAD pixels, other ops) of one `refine_wide` call: both
    luma planes, `pre` and the outputs; per block pixel a SAD for each
    of the (2R + 1)^2 - 1 offsets of the full-pel window (R = 2 effort)
    and the 28 ops of `work_hme_base`'s statistics; per in-frame block
    the half-pel stage on the +-(1 + effort) grid (`_half_pel`)."""
    _src, _ref, lay, nbh_l, nb, BW, BH, pre, effort = wargs
    p = lay.planes[0]
    B = pre[0].shape[0]
    nbv_l = nb // nbh_l
    inframe = min(nbh_l, -(-p.w // BW)) * min(nbv_l, -(-p.h // BH))
    offsets = (4 * effort + 1) ** 2 - 1
    nbytes = 2 * B * (p.h + 2 * p.ext) * p.stride + B * nb * 9 * 4
    area = B * _search_area(p.w, p.h, nbh_l, nb, BW, BH)
    hp_sad, hp_ops = _half_pel(B * inframe, 1 + effort)
    return nbytes, area * offsets + hp_sad, area * 28 + hp_ops


def hme_bounds(work, bound):
    """The HME rows' bound from (bytes, SAD pixels, other scalar ops):
    u8 pixels packed four to an instruction, SAD_SLOTS INT32 issue slots
    per 4 pixels of a SAD and one per 4 pixels of every other per-pixel
    op, with the scalar count's bound (SAD_OPS a SAD pixel) and the
    bytes bound beside it: (bound_ms, bound_by, extra row fields)."""
    nbytes, sad, ops = work
    b_ms, b_by = bound(nbytes, (SAD_SLOTS * sad + ops) / U8_PER_WORD)
    return b_ms, b_by, {"scalar_ops_bound_ms": bound(0, SAD_OPS * sad
                                                     + ops)[0],
                        "bytes_bound_ms": bound(nbytes, 0)[0]}


def work_mc(planes, nbh, nbv, fields):
    """(bytes, ops) of one frame's prediction with this field: per inter
    block the neighbourhood its phase reads (luma 3 more rows for a
    vertical half-pel, 3 more columns for a horizontal one; chroma one
    more of each), per intra block its zero-MV window, every pixel
    written once, 16 B of fields per block. Ops per pixel: 8 for a luma
    vertical or horizontal half-pel, 30 for the luma diagonal (four
    horizontal 4-taps and a vertical one), 4 and 6 for chroma, 0 for a
    full-pel copy, 4 for an intra pixel (sum, quadrant, divide)."""
    import numpy as np

    from dsv1_tpu_torch.constants import MODE_INTER
    modes, mvx, mvy, _ = (f.reshape(-1).cpu().numpy().astype(np.int64)
                          for f in fields)
    inter = modes == MODE_INTER
    nbytes, ops = 16 * modes.size, 0
    for c, g in enumerate(planes):
        bw_c = np.clip(g.w - np.tile(np.arange(nbh) * g.BW, nbv), 0, g.BW)
        bh_c = np.clip(g.h - np.repeat(np.arange(nbv) * g.BH, nbh), 0, g.BH)
        px = bw_c * bh_c
        xh, yh = (mvx >> g.sh) & 1, (mvy >> g.sv) & 1
        k = 3 if c == 0 else 1
        nb = (bh_c + k * yh) * (bw_c + k * xh)
        nbytes += int(np.where(inter, nb, px).sum() + px.sum())
        per = np.where(xh & yh, 30 if c == 0 else 6,
                       np.where(xh | yh, 8 if c == 0 else 4, 0))
        ops += int((np.where(inter, per, 4) * px).sum())
    return nbytes, ops


def work_haar(hs, ws):
    """(bytes, ops) of a Haar pyramid on a (hs, ws) region: each int32
    of the region read once, each band value and the last LL written
    once (as many values as the region has); 8 adds and the LL scale
    per 2x2 quad, about 3 ops per pixel at the first level and a third
    more for the levels below it."""
    return 8 * hs * ws, 4 * hs * ws


def row(name, source, replaces, err, ms, plain_ms, b_ms, b_by, **extra):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, **extra}


def gop_motion(dev, frames, G=None, effort=0):
    """A GOP's motion (G frames, the golden GOP by default) through the
    port's encoder at `effort`; returns (encoder, images, motion dict,
    the HME kernels' calls)."""
    import numpy as np
    import torch

    import dsv1_tpu_torch as dt
    from dsv1_tpu_torch.parallel.gop import build_gop_encoder
    from dsv1_tpu_torch.utils.golden import GOP, QUALITY_PCT

    G = G or GOP
    h, w = frames[0][0].shape
    enc = build_gop_encoder(dt.SUBSAMP_420, w, h, G,
                            dt.quality_percent(QUALITY_PCT), True, 4, 50,
                            G - 1, 0, str(dev), None, effort)
    packed = torch.from_numpy(np.stack([
        np.concatenate([np.asarray(p, np.uint8).ravel() for p in f])
        for f in frames[:G]])).to(dev)
    calls = []
    imgs, _al, mv, _has_ref = enc.motion(packed, calls=calls)
    return enc, imgs, mv, calls


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur = 0.0, None
    for a, b in sorted(intervals):
        if cur is None or a > cur[1]:
            total += 0 if cur is None else cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    return total + (0 if cur is None else cur[1] - cur[0])


def device_ms(fn, reps: int) -> float:
    """Device time of fn() per call over reps calls, after one warm-up:
    the union of torch.profiler's kernel intervals (memcpy and memset
    left out), which is the kernels' sum where they do not overlap; a
    kernel chained by programmatic dependent launch (the inverse's) starts
    before the one it waits on ends, and its duration counts that wait."""
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
    return union_us((e.time_range.start, e.time_range.end)
                    for e in prof.events()
                    if e.device_type == DeviceType.CUDA
                    and not e.name.startswith(("Memcpy", "Memset"))) \
        * 1e-3 / reps


def fuzz_cands(rng, dev, B, nb, w, h):
    """(B, nb, 6) cmx, cmy: mostly near-zero MVs, the rest up to three
    frame sizes away, slot 0 the zero MV, some duplicates."""
    import numpy as np
    import torch
    cm = rng.integers(-3 * w, 3 * w, (B, nb, 12)).astype(np.int32)
    cm[:, :, 6:] = rng.integers(-3 * h, 3 * h, (B, nb, 6))
    small = rng.random((B, nb, 12)) < 0.6
    cm = np.where(small, rng.integers(-9, 10, cm.shape), cm).astype(np.int32)
    cm[:, :, 0] = cm[:, :, 6] = 0
    cm[:, 1::3, 2] = cm[:, 1::3, 1]
    t = torch.from_numpy(cm).to(dev)
    return t[..., :6].contiguous(), t[..., 6:].contiguous()


def base_plain(bargs):
    """refine_base_plain on hme_batch's `hme_base` arguments (candidates
    as one (B, nb, 2 NC) tensor)."""
    from dsv1_tpu_torch.ops import hme_kernels as hk
    src, ref, lay, cm, *rest = bargs
    nc = cm.shape[-1] // 2
    return hk.refine_base_plain(src, ref, lay, cm[..., :nc], cm[..., nc:],
                                *rest)


def check_hme_edges(dev, seed):
    """The HME kernels vs their plain versions on a 1918x1078 clip of 3
    frames (luma width not a multiple of 4 or of the 64-wide block, odd
    widths at the coarse levels): `refine_coarse` and `refine_base_cm`
    on the encoder's own arguments, `refine_base` and `refine_level` (at
    levels 1 and the top) on fuzzed candidates. Returns the largest
    error of the coarse search and of level 0."""
    import numpy as np

    import dsv1_tpu_torch as dt
    from dsv1_tpu_torch.ops import hme_kernels as hk
    from dsv1_tpu_torch.utils import corpus
    w, h, n = 1918, 1078, 3
    frames = corpus.split_frames(corpus.make_clip(w, h, dt.SUBSAMP_420, n,
                                                  seed=seed),
                                 w, h, dt.SUBSAMP_420, n)
    enc, _imgs, _mv, calls = gop_motion(dev, frames, n)
    (cargs,) = [a for name, a in calls if name == "hme_coarse"]
    (bargs,) = [a for name, a in calls if name == "hme_base"]
    err_c = max_abs_err(hk.refine_coarse(*cargs),
                        hk.refine_coarse_plain(*cargs))
    err_b = max_abs_err(hk.refine_base_cm(*bargs), base_plain(bargs))
    rng = np.random.default_rng(seed)
    B = bargs[0].shape[0]
    fb = (*bargs[:3], *fuzz_cands(rng, dev, B, enc.nbh * enc.nbv, w, h),
          *bargs[4:])
    err_b = max(err_b, max_abs_err(hk.refine_base(*fb),
                                   hk.refine_base_plain(*fb)))
    for level in (1, enc.levels):
        nbh_l = -(-enc.nbh // (1 << level))
        nb = nbh_l * -(-enc.nbv // (1 << level))
        la = (cargs[0][level], cargs[1][level], enc.layouts[level],
              *fuzz_cands(rng, dev, B, nb, w, h), nbh_l, nb, enc.blk_w,
              enc.blk_h, level)
        err_c = max(err_c, max_abs_err(hk.refine_level(*la),
                                       hk.refine_level_plain(*la)))
    return err_c, err_b


def haar_case(dev, hs, ws, is_p, seed):
    """The arguments fwd_sbt gives haar_fwd_pyramid for a (hs, ws) plane
    of random centred coefficients: (region, out, first, lvls); for an
    I plane out holds the B4T level and the region is a copy of its LL."""
    import numpy as np
    import torch
    from dsv1_tpu_torch.ops import sbt
    a = np.random.default_rng(seed).integers(-255, 256, (hs, ws))
    coefs = torch.from_numpy(a.astype(np.int32)).to(dev)
    lvls = sbt.nlevels(ws, hs)
    if is_p:   # out starts as a sentinel no band value can take
        return coefs, torch.full_like(coefs, -2**31), 1, lvls
    out = sbt._b4t_fwd_2d(coefs)
    return out[:(hs + 1) // 2, :(ws + 1) // 2].clone(), out, 2, lvls


def check_haar(dev, hs, ws, is_p, seed, timed=True):
    """haar_fwd_pyramid on one plane, kernel vs plain: (max_abs_err,
    kernel ms, plain ms, kernel device ms, (bytes, ops))."""
    from dsv1_tpu_torch.ops import sbt
    cur, out, first, lvls = haar_case(dev, hs, ws, is_p, seed)
    out_k, out_p = out.clone(), out.clone()
    sbt.haar_fwd_pyramid(cur, out_k, first, lvls)
    sbt._haar_fwd_pyramid_plain(cur, out_p, first, lvls)
    err = max_abs_err(out_k, out_p)
    if not timed:
        return err, None, None, None, None
    kern = lambda: sbt.haar_fwd_pyramid(cur, out_k, first, lvls)  # noqa
    return (err, cuda_ms(kern, 50),
            cuda_ms(lambda: sbt._haar_fwd_pyramid_plain(cur, out_p, first,
                                                        lvls), 5),
            device_ms(kern, 50), work_haar(*cur.shape))


def check_mc(dev, enc, imgs, mv, seed):
    """compensate_frame on the P frame with the most intra blocks, with
    its HME field and with a fuzzed one (random modes and submasks, MVs
    far past the plane edges), kernel vs plain: (max_abs_err, kernel ms,
    plain ms, kernel device ms, (bytes, ops), intra blocks), the times
    and work on the HME field."""
    import torch

    from dsv1_tpu_torch.ops import bmc, mc
    H, W, nbh, nbv = enc.h, enc.w, enc.nbh, enc.nbv
    k = int(mv["nintra"].argmax())
    gen = torch.Generator().manual_seed(seed)

    def fuzz(hi, lo=0):
        return torch.randint(lo, hi, (nbv * nbh,), generator=gen,
                             dtype=torch.int32).to(dev)

    fields = [tuple(mv[key][k] for key in ("mode", "mvx", "mvy",
                                           "submask")),
              (fuzz(2), fuzz(4 * W, -4 * W), fuzz(4 * H, -4 * H), fuzz(16))]
    img, geo = imgs[0][k], (enc.layouts[0], enc.blk_w, enc.blk_h, nbh, nbv)
    err = max(max_abs_err(mc.predict_frame(img, *geo, *f),
                          mc.predict_frame_plain(img, *geo, *f))
              for f in fields)
    f = fields[0]
    kern = lambda: bmc.compensate_frame(img, *geo, *f)  # noqa: E731
    planes, _ = mc.frame_geometry(*geo[:3])
    return (err, cuda_ms(kern, 50),
            cuda_ms(lambda: mc.predict_frame_plain(img, *geo, *f), 5),
            device_ms(kern, 50), work_mc(planes, nbh, nbv, f),
            int(mv["nintra"][k]))


# per-position integer operations of the recon kernels' algorithms (the
# bound's operation count; each is bound by bytes at these rates): the
# prologue's subtract, add, clamp and centring; a B4T output's two 1-D
# taps (4 products and sums, a sign-symmetric round, a pass each way);
# the quantizer's TMQ, |v|, the truncating division (about 20
# instructions) and the write-back; the dequantizer's multiply-add;
# the inverse's butterfly, / 4, the luma nudge (about 30 per quad, on
# two of its bands) and the epilogue's clamps, a third more for the
# coarser levels
RECON_OPS = {"residual_in": 5, "b4t_fwd": 22, "hzcc_quant": 35,
             "hzcc_dequant": 8, "inv_sbt": 27}


def work_recon(name, dims, planes, is_p, N=0, ext=0):
    """(bytes, ops) of one recon kernel call on one plane (dims (cw, ch),
    planes [(h, w)]) or, for `residual_in`, a frame's three: each input
    read once and each output written once. residual_in: the u8 frame
    (and prediction) in, int32 coefficients out; b4t_fwd: int32 in,
    int32 out and the int32 LL copy; hzcc_quant: int32 in, the int32
    grid and its N traversal values out; hzcc_dequant: int32 in and out;
    inv_sbt (the recon): int32 coefficients (and the u8 prediction) in,
    the u8 plane with its `ext` border out."""
    if name == "residual_in":
        n_c = sum(cw * ch for cw, ch in dims)
        n_p = sum(h * w for h, w in planes)
        return n_p * (1 + is_p) + 4 * n_c, RECON_OPS[name] * n_c
    (cw, ch), (h, w) = dims[0], planes[0]
    n = cw * ch
    nbytes = {"b4t_fwd": 4 * n + 4 * n + n,
              "hzcc_quant": 8 * n + 4 * N,
              "hzcc_dequant": 8 * n,
              "inv_sbt": 4 * n + h * w * is_p
              + (h + 2 * ext) * (w + 2 * ext)}[name]
    return nbytes, RECON_OPS[name] * n


def recon_frames(dev, subsamp, frames, C, seed):
    """C frames of a clip (or random frames, `frames` a (w, h) pair) as a
    batch for the recon chain: (layout, coefficient dims, traversal
    tables, images (C, n) u8, the three predictions (C, h, w) u8 as
    views of one buffer as compensate_frame gives them, per-block stable
    flags (C, nblk) u8 with every value the encoder gives)."""
    import numpy as np
    import torch

    from dsv1_tpu_torch.models.encoder import block_geometry, coef_geometry
    from dsv1_tpu_torch.ops import frame as fr
    rng = np.random.default_rng(seed)
    if isinstance(frames, tuple):
        w, h = frames
    else:
        h, w = frames[0][0].shape
    _bw, _bh, nbh, nbv = block_geometry(w, h)
    layout, dims, tables = coef_geometry(subsamp, w, h, nbh, nbv)

    def batch(k0):
        if isinstance(frames, tuple):
            return [torch.from_numpy(rng.integers(0, 256, (C, p.h, p.w))
                                     .astype(np.uint8)).to(dev)
                    for p in layout.planes]
        return [torch.from_numpy(np.stack([
            np.asarray(frames[k0 + k][c], np.uint8) for k in range(C)]))
            .to(dev) for c in range(3)]
    img = fr.image_from_planes(layout, batch(1))
    flat = torch.cat([p.reshape(C, -1) for p in batch(0)], -1)
    preds, off = [], 0
    for p in layout.planes:
        preds.append(flat[:, off:off + p.h * p.w].unflatten(-1, (p.h, p.w)))
        off += p.h * p.w
    stable = torch.from_numpy(rng.integers(0, 4, (C, nbh * nbv))
                              .astype(np.uint8)).to(dev)
    return layout, dims, tables, img, tuple(preds), stable


def qgrid_of(qv, tables, shape):
    """The decoder's grid `shape` (C, H, W) of traversal values qv (C,
    N): the parser's scatter, later segments winning where bands
    alias."""
    import numpy as np
    import torch
    q = qv.cpu().numpy()
    g = np.zeros((q.shape[0], shape[-2] * shape[-1]), np.int32)
    for b in range(q.shape[0]):
        g[b][tables.perm] = q[b]   # sequential: the last write wins
    return torch.from_numpy(g.reshape(shape)).to(qv.device)


def check_recon_chain(dev, case, is_p, q, fuzz=False):
    """The recon chain of a batch (`recon_frames`), each kernel against
    its plain version on the same inputs, stage by stage: residual_in;
    per plane b4t_fwd (intra), hzcc_quant on fwd_sbt's coefficients
    (random int32 values up to +-2^15 with `fuzz`), hzcc_dequant on its
    values as the parser's grid, inv_sbt (int32) and the recon
    (inv_sbt_recon into frame images, with the prediction for P). q: a
    python int, or a quant per frame (a list). Returns {kernel:
    max_abs_err}."""
    import numpy as np
    import torch

    from dsv1_tpu_torch.ops import bmc, hzcc, sbt
    layout, dims, tables, img, preds, stable = case
    C = img.shape[0]
    qq = (torch.tensor(q, dtype=torch.int32, device=dev)
          if isinstance(q, list) else q)
    pr = preds if is_p else None
    err = {}

    def put(k, a, b):
        err[k] = max(err.get(k, 0), max_abs_err(a, b))
    planes = bmc.residual_in(img, layout, dims, pr)
    put("residual_in", planes, bmc.residual_in_plain(img, layout, dims, pr))
    n = layout.total + 2 * layout.margin
    rec_k = torch.zeros((C, n), dtype=torch.uint8, device=dev)
    rec_p = rec_k.clone()
    rng = np.random.default_rng(C * 7 + is_p)
    for c in range(3):
        x = planes[c]
        if not is_p:
            put("b4t_fwd", sbt.b4t_fwd(x), sbt.b4t_fwd_plain(x))
        coefs = sbt.fwd_sbt(x, is_p)
        if fuzz:
            coefs = torch.from_numpy(rng.integers(
                -2**15, 2**15, tuple(coefs.shape)).astype(np.int32)).to(dev)
        qv, wb = hzcc.encode_plane_core(coefs, qq, is_p, c, stable,
                                        tables[c])
        put("hzcc_quant", (qv, wb), hzcc.encode_plane_core_plain(
            coefs, qq, is_p, c, stable, tables[c]))
        qg = qgrid_of(qv, tables[c], tuple(coefs.shape))
        dc = coefs[:, 0, 0].contiguous()
        put("hzcc_dequant",
            hzcc.dequant_plane_grid(qg, dc, qq, is_p, c, stable, tables[c]),
            hzcc.dequant_plane_grid_plain(qg, dc, qq, is_p, c, stable,
                                          tables[c]))
        put("inv_sbt", sbt.inv_sbt(wb, qq, is_p, c == 0),
            sbt.inv_sbt_plain(wb, qq, is_p, c == 0))
        sbt.inv_sbt_recon(wb, qq, is_p, c == 0, rec_k, layout, c,
                          pr[c] if is_p else None)
        sbt.recon_epilogue_plain(sbt.inv_sbt_plain(wb, qq, is_p, c == 0),
                                 rec_p, layout, c, pr[c] if is_p else None)
    put("inv_sbt", rec_k, rec_p)
    return err


def recon_rows(dev, bound, clips):
    """The recon chain's kernels against their plain versions
    (check_recon_chain) on CIF, 1080p and 3840x2160 golden frames, I and
    P, every plane, one frame (B = 1, the encoder's python-int quant)
    and batched with a quant per frame (CIF 4, 1080p 3, 4K 2; chroma
    quants past CHROMA_LIMIT too), on fuzzed coefficients at 1080p, and
    on random frames at 100x84 (aliasing bands), 98x82 (odd chroma dims
    rounded up) and 4:2:2 and 4:1:1 at 96x80 and 1920x1080, at 102x86
    and 1918x1078 (odd level sizes at several depths; C = 4, a quant per
    plane; int32 stability maps) and at 1776x1760 (the inverse's largest
    coarse stage, fuzzed coefficients once); then each
    kernel timed on the main path's unit of work at 1080p (a luma plane,
    residual_in a frame; the recon with its P prediction), with *_4k and
    *_cif beside it. Returns the rows and each case's errors."""
    import torch

    import dsv1_tpu_torch as dt
    from dsv1_tpu_torch.ops import bmc, hzcc, sbt
    cases, worst = [], {}
    batches = {"cif": 4, "1080p": 3, "4k_cli": 2}
    built = {}
    for name, C in batches.items():
        frames = clips[name][1]
        built[name] = recon_frames(dev, dt.SUBSAMP_420, frames, 1, 5)
        big = recon_frames(dev, dt.SUBSAMP_420, frames, C, 6)
        runs = [("B=1", built[name], 300, False),
                (f"B={C}", big, [85, 1540, 300, 4000][:C], False)]
        if name == "1080p":
            runs.append(("fuzz", big, [700, 90, 3000, 160][:C], True))
        for is_p in (False, True):
            for tag, case, q, fuzz in runs:
                e = check_recon_chain(dev, case, is_p, q, fuzz)
                cases.append({"case": f"{name} {tag} "
                              f"{'P' if is_p else 'I'}", "errors": e})
        del big
    for (w, h), ss in (((100, 84), dt.SUBSAMP_420),
                       ((98, 82), dt.SUBSAMP_420),
                       ((96, 80), dt.SUBSAMP_422),
                       ((96, 80), dt.SUBSAMP_411),
                       ((1920, 1080), dt.SUBSAMP_422),
                       ((1920, 1080), dt.SUBSAMP_411)):
        case = recon_frames(dev, ss, (w, h), 3, w + ss)
        fmt = {dt.SUBSAMP_420: "4:2:0", dt.SUBSAMP_422: "4:2:2",
               dt.SUBSAMP_411: "4:1:1"}[ss]
        for is_p in (False, True):
            e = check_recon_chain(dev, case, is_p, [85, 600, 1540])
            cases.append({"case": f"{w}x{h} {fmt} "
                          f"{'P' if is_p else 'I'} B=3", "errors": e})
    # tiles, halos and segment runs on odd level sizes at several depths,
    # a quant per plane of a C = 4 batch, int32 stability maps, and the
    # largest coarse stage of the inverse (a 48,840-byte corner in every
    # plane, its threads holding up to 3 quads a level)
    for (w, h), C, q, i32, fuzz in (
            ((102, 86), 4, [85, 600, 1540, 2047], False, False),
            ((1918, 1078), 4, [85, 600, 1540, 300], True, False),
            ((1776, 1760), 2, [300, 2047], False, False),
            ((1776, 1760), 2, [700, 90], True, True)):
        lay, dims, tabs, img, preds, stable = recon_frames(
            dev, dt.SUBSAMP_420, (w, h), C, w + C)
        if i32:
            stable = stable.to(torch.int32)
        case = (lay, dims, tabs, img, preds, stable)
        for is_p in (False, True):
            e = check_recon_chain(dev, case, is_p, q, fuzz)
            cases.append({"case": f"{w}x{h} 4:2:0 {'P' if is_p else 'I'} "
                          f"B={C}" + (" int32 stable" if i32 else "")
                          + (" fuzz" if fuzz else ""), "errors": e})
        del case, img, preds
    for c in cases:
        for k, v in c["errors"].items():
            worst[k] = max(worst.get(k, 0), v)

    def unit(name, key):
        """(fn, plain fn, work) of a kernel's unit of work on clip
        `name`'s frame: the 1080p luma plane (residual_in: the frame)."""
        layout, dims, tables, img, preds, stable = built[name]
        p0 = layout.planes[0]
        pl = [(p.h, p.w) for p in layout.planes]
        planes = bmc.residual_in(img, layout, dims, preds)
        if key == "residual_in":
            return (lambda: bmc.residual_in(img, layout, dims, preds),
                    lambda: bmc.residual_in_plain(img, layout, dims, preds),
                    work_recon(key, dims, pl, True))
        if key == "b4t_fwd":
            x = bmc.residual_in(img, layout, dims, None)[0]
            return (lambda: sbt.b4t_fwd(x), lambda: sbt.b4t_fwd_plain(x),
                    work_recon(key, dims[:1], pl[:1], False))
        coefs = sbt.fwd_sbt(planes[0], True)
        qv, wb = hzcc.encode_plane_core(coefs, 300, True, 0, stable,
                                        tables[0])
        if key == "hzcc_quant":
            return (lambda: hzcc.encode_plane_core(coefs, 300, True, 0,
                                                   stable, tables[0]),
                    lambda: hzcc.encode_plane_core_plain(
                        coefs, 300, True, 0, stable, tables[0]),
                    work_recon(key, dims[:1], pl[:1], True, tables[0].n))
        if key == "hzcc_dequant":
            qg = qgrid_of(qv, tables[0], tuple(coefs.shape))
            return (lambda: hzcc.dequant_plane_grid(
                        qg, 5, 300, True, 0, stable, tables[0]),
                    lambda: hzcc.dequant_plane_grid_plain(
                        qg, 5, 300, True, 0, stable, tables[0]),
                    work_recon(key, dims[:1], pl[:1], True))
        rec = torch.zeros_like(img)
        return (lambda: sbt.inv_sbt_recon(wb, 300, True, True, rec, layout,
                                          0, preds[0]),
                lambda: sbt.recon_epilogue_plain(
                    sbt.inv_sbt_plain(wb, 300, True, True), rec, layout, 0,
                    preds[0]),
                work_recon(key, dims[:1], pl[:1], True, ext=p0.ext))

    rows = []
    sources = {"residual_in": ("dsv1_tpu_torch/csrc/recon.cu",
                               "dsv1_tpu/models/encoder.py:219"),
               "b4t_fwd": ("dsv1_tpu_torch/csrc/recon.cu",
                           "dsv1_tpu/ops/sbt.py:288"),
               "hzcc_quant": ("dsv1_tpu_torch/csrc/hzcc.cu",
                              "dsv1_tpu/ops/hzcc.py:191"),
               "hzcc_dequant": ("dsv1_tpu_torch/csrc/hzcc.cu",
                                "dsv1_tpu/ops/hzcc.py:236"),
               "inv_sbt": ("dsv1_tpu_torch/csrc/recon.cu",
                           "dsv1_tpu/ops/sbt.py:434")}
    for key, (src, rep) in sources.items():
        fn, plain, work = unit("1080p", key)
        extra = {}
        for name, tag in (("4k_cli", "4k"), ("cif", "cif")):
            f2, p2, w2 = unit(name, key)
            extra.update({f"ms_{tag}": cuda_ms(f2, 30),
                          f"plain_ms_{tag}": cuda_ms(p2, 3),
                          f"device_ms_{tag}": device_ms(f2, 30),
                          f"bound_ms_{tag}": bound(*w2)[0]})
        shape = ("one 1080p P frame, 3 planes" if key == "residual_in"
                 else "1080p luma I plane" if key == "b4t_fwd"
                 else "1080p luma P plane" + (
                     ", the recon into the frame image with its "
                     "prediction" if key == "inv_sbt" else ""))
        rows.append(row(key, src, rep, worst.get(key, 0), cuda_ms(fn, 50),
                        cuda_ms(plain, 5), *bound(*work), shape=shape,
                        device_ms=device_ms(fn, 50), **extra,
                        launches_per_call=(sbt.inv_plan(1920, 1080)[2]
                                           if key == "inv_sbt" else 1),
                        cases=len(cases)))
    return rows, cases


def compact_chunk(dev, w, h, C, seed, dense=False):
    """A chunk's quantized planes as `GopEncoder.chain_steps` holds them
    (per plane c, (C, 12, N_c) int32 on dev) with their nonzero counts
    (3, C * 12): mostly sparse, with the causes of overflow in it: a
    nearly empty row (runs past 0xFFFE), an empty row, values past int16,
    |q| > 127 outside the LL; with `dense` the P slots of frame 1 also
    hold more nonzeros than any P cap takes (both caps overflow)."""
    import numpy as np
    import torch

    import dsv1_tpu_torch as dt
    from dsv1_tpu_torch.models.encoder import block_geometry, coef_geometry
    rng = np.random.default_rng(seed)
    tables = coef_geometry(dt.SUBSAMP_420, w, h,
                           *block_geometry(w, h)[2:])[2]
    n = 12
    planes, counts = [], []
    for c, t in enumerate(tables):
        dens = np.full((C, n, 1), 0.01)
        if dense:
            dens[:, 1] = 0.1
        # device-side draws: a 4K chunk is 100 M positions a plane
        g = torch.Generator(device=dev).manual_seed(seed * 3 + c)
        u = torch.rand((C, n, t.n), generator=g, device=dev)
        mag = torch.randint(1, 60, (C, n, t.n), generator=g, device=dev,
                            dtype=torch.int32)
        q = torch.where(u < torch.from_numpy(dens).float().to(dev),
                        torch.where(u < 0.003, -mag, mag), 0) \
            .to(torch.int32)
        q[0, 2] = 0
        q[0, 2, rng.integers(0, t.n, 2)] = 5
        q[0, 3] = 0
        q[0, 4, rng.integers(0, t.n, 4)] = torch.tensor(
            [40000, -70000, 300, -128], dtype=torch.int32, device=dev)
        q[:, 0, t.n - 1] = 1000
        planes.append(q.contiguous())
        counts.append((q != 0).sum(-1).reshape(-1).cpu().numpy())
    return planes, np.stack(counts), tables


def intra_row(dev, w, h, seed):
    """One gop-0 frame's quantized planes as `_encode_intra` hands them
    to the exact compaction when its chunk is one frame, as at UHD (per
    plane c, (1, N_c) int32 on dev) with their nonzero counts (3, 1):
    12 % nonzero, an empty stretch of 70,000 positions (a run past
    0xFFFE), values past int16 and |q| > 127 outside the LL, so the
    I cap overflows."""
    import numpy as np
    import torch

    import dsv1_tpu_torch as dt
    from dsv1_tpu_torch.models.encoder import block_geometry, coef_geometry
    rng = np.random.default_rng(seed)
    tables = coef_geometry(dt.SUBSAMP_420, w, h,
                           *block_geometry(w, h)[2:])[2]
    planes, counts = [], []
    for c, t in enumerate(tables):
        g = torch.Generator(device=dev).manual_seed(seed * 5 + c)
        u = torch.rand((1, t.n), generator=g, device=dev)
        mag = torch.randint(1, 60, (1, t.n), generator=g, device=dev,
                            dtype=torch.int32)
        q = torch.where(u < 0.12, torch.where(u < 0.04, -mag, mag), 0) \
            .to(torch.int32)
        q[0, 1000:71000] = 0
        q[0, rng.integers(71000, t.n, 4)] = torch.tensor(
            [40000, -70000, 300, -128], dtype=torch.int32, device=dev)
        q[0, t.n - 1] = 1000
        planes.append(q.contiguous())
        counts.append((q != 0).sum(-1).cpu().numpy())
    return planes, np.stack(counts), tables


def compact_rows(dev, bound):
    """`hzcc_compact` (ops/hzcc.py compact_exact, csrc/hzcc.cu) against
    its plain version on a 12-frame chunk at 1080p (1 GOP), at 4K with
    both caps overflowed (the compactions' verdicts say so), at CIF (4
    GOPs a chunk, the JAX rule) and on one UHD intra frame's row, gop
    0's chunk at UHD, with the I cap overflowed (`intra_row`), three
    launches a call; timed at 4K and on the UHD intra row beside the
    route it replaced on the host (the dense int32 read and numpy
    runs_from_qvals a plane of every frame) and its own (the kernel, the
    one read of the lists and their cutting), host clock."""
    import numpy as np
    import torch

    from dsv1_tpu_torch.kernels.build import LAUNCHES
    from dsv1_tpu_torch.ops import hzcc
    from dsv1_tpu_torch.utils.blob import fetch
    err, extra, cases = 0, {}, []
    for name, (w, h), C, dense in (("1080p", (1920, 1080), 1, False),
                                   ("4k", (3840, 2160), 1, True),
                                   ("cif", (352, 288), 4, False),
                                   ("4k_intra", (3840, 2160), 1, False)):
        intra = name == "4k_intra"
        if intra:
            planes, counts, tables = intra_row(dev, w, h, 17)
            i_rows = planes
        else:
            planes, counts, tables = compact_chunk(dev, w, h, C, 17, dense)
            i_rows = [q[:, 0] for q in planes]
        total = int(counts.sum())
        before = LAUNCHES["hzcc_compact"]
        got = hzcc.compact_exact(planes, total)
        torch.cuda.synchronize()
        if LAUNCHES["hzcc_compact"] - before != 3:
            raise AssertionError("hzcc_compact: not 3 launches a call")
        want = hzcc.compact_exact_plain(planes, total)
        bad = int((got != want).sum())
        err = max(err, bad)
        host = got.cpu().numpy()
        lists = hzcc.exact_lists(host, counts)
        dq = [q.reshape(-1, q.shape[-1]).cpu().numpy() for q in planes]
        for c in range(3):
            for r in sorted({0, 2, 3, 4, len(dq[c]) - 1}
                            & set(range(len(dq[c])))):
                want_r = hzcc.runs_from_qvals(dq[c][r])
                if not (np.array_equal(lists[c][r][0], want_r[0])
                        and np.array_equal(lists[c][r][1], want_r[1])):
                    raise AssertionError(f"hzcc_compact {name}: plane {c} "
                                         f"row {r} differs from "
                                         "runs_from_qvals")
        ovf_i = any(int(hzcc.compact_dense_i(q, hzcc.ll_size(t))[3]
                        .max()) > 0 for q, t in zip(i_rows, tables))
        ovf_p = not intra and any(
            bool(hzcc.compact_sparse_p(q[:, 1:], 16)[3].any())
            for q in planes)
        positions = sum(q.numel() for q in planes)
        work = (4 * positions + 8 * total + 4, 0)
        cases.append({"case": name, "rows": 1 if intra else 12 * C,
                      "positions": positions, "symbols": total,
                      "mismatches": bad, "overflow_i": ovf_i,
                      "overflow_p": ovf_p})
        if name == "4k" and not (ovf_i and ovf_p):
            raise AssertionError("the 4K chunk must overflow both caps")
        if intra and not ovf_i:
            raise AssertionError("the UHD intra row must overflow the I cap")
        fn = lambda: hzcc.compact_exact(planes, total)  # noqa: E731
        tag = "" if name == "4k" else f"_{name}"
        extra.update({f"ms{tag}": cuda_ms(fn, 20),
                      f"device_ms{tag}": device_ms(fn, 20),
                      f"plain_ms{tag}": cuda_ms(
                          lambda: hzcc.compact_exact_plain(planes, total), 3),
                      f"bound_ms{tag}": bound(*work)[0]})
        if name in ("4k", "4k_intra"):
            def parent_route():
                d = fetch({"dense": torch.cat(planes, -1)})["dense"]
                off = np.cumsum([0] + [t.n for t in tables])
                return [hzcc.runs_from_qvals(row[off[c]:off[c + 1]])
                        for row in d.reshape(-1, off[-1]) for c in range(3)]

            def exact_route():
                return hzcc.exact_lists(fetch({"syms": hzcc.compact_exact(
                    planes, total)})["syms"], counts)
            for key, fn in (("parent_route_ms", parent_route),
                            ("exact_route_ms", exact_route)):
                fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(3):
                    fn()
                extra[key + tag] = (time.perf_counter() - t0) * 1e3 / 3
        del planes, got, want, host, lists, dq
        torch.cuda.empty_cache()
    emit({"phase": "kernels", "compact_cases": cases})
    return row("hzcc_compact", "dsv1_tpu_torch/csrc/hzcc.cu",
               "none (the host's numpy runs_from_qvals over the dense "
               "planes, ops/hzcc.py)", err, extra.pop("ms"),
               extra.pop("plain_ms"), extra.pop("bound_ms"), "bytes",
               shape="a 12-frame 4K chunk (149 M positions), both caps "
                     "overflowed; *_1080p: 1 GOP, *_cif: 4 GOPs; "
                     "*_4k_intra: one UHD intra frame (12.4 M positions, "
                     "12 % nonzero), the I cap overflowed",
               launches_per_call=3, **extra)


def phase_kernels(dev, bound, clips):
    """Each kernel vs its plain version at the main path's 1080p and 4K
    shapes, on the arguments the main path itself passes to the kernel."""
    import torch

    from dsv1_tpu_torch.ops import hme_kernels as hk

    _yuv, frames = clips["1080p"]
    enc, imgs, mv, calls = gop_motion(dev, frames)
    H, W = frames[0][0].shape
    (cargs,) = [a for name, a in calls if name == "hme_coarse"]
    (bargs,) = [a for name, a in calls if name == "hme_base"]
    B = bargs[0].shape[0]
    bw, bh, nbh, nbv = enc.blk_w, enc.blk_h, enc.nbh, enc.nbv
    rows = []

    # edge geometries (errors only): odd widths, partial blocks, MVs far
    # past the clamps
    edge_coarse, edge_base = check_hme_edges(dev, 13)

    # --- the coarse levels, one C call: its level-0 candidates vs plain
    err = max(max_abs_err(hk.refine_coarse(*cargs),
                          hk.refine_coarse_plain(*cargs)), edge_coarse)
    kern = lambda: hk.refine_coarse(*cargs)  # noqa: E731
    ms = cuda_ms(kern, 20)
    plain_ms = cuda_ms(lambda: hk.refine_coarse_plain(*cargs), 3)
    b_ms, b_by, b_extra = hme_bounds(work_hme_coarse(cargs), bound)
    rows.append(row("hme_refine", "dsv1_tpu_torch/csrc/hme.cu",
                    "dsv1_tpu/ops/pallas_hme.py:130", err, ms, plain_ms,
                    b_ms, b_by,
                    shape=f"1080p levels {enc.levels}..1 and the level-0 "
                          f"candidates, B={B}", device_ms=device_ms(kern, 20),
                    edge_max_abs_err=edge_coarse, **b_extra))

    # --- level 0
    err = max(max_abs_err(hk.refine_base_cm(*bargs), base_plain(bargs)),
              edge_base)
    kern = lambda: hk.refine_base_cm(*bargs)  # noqa: E731
    ms = cuda_ms(kern, 20)
    plain_ms = cuda_ms(lambda: base_plain(bargs), 3)
    b_ms, b_by, b_extra = hme_bounds(work_hme_base(bargs), bound)
    rows.append(row("hme_base", "dsv1_tpu_torch/csrc/hme.cu",
                    "dsv1_tpu/ops/pallas_hme.py:339", err, ms, plain_ms,
                    b_ms, b_by, shape=f"1080p B={B} nb={nbh * nbv} {bw}x{bh}",
                    device_ms=device_ms(kern, 20),
                    edge_max_abs_err=edge_base, **b_extra))

    # --- MC, one call per frame: 1080p here, 4K below
    mc_1080 = check_mc(dev, enc, imgs, mv, 11)
    del imgs, mv, calls, cargs, bargs

    # --- the 4K GOP: level 0 is what the JAX package runs as its banded
    # kernel there (planes past MAX_PLANE_BYTES); the port's one kernel
    _yuv, frames4 = clips["4k_cli"]
    enc4, imgs4, mv4, calls4 = gop_motion(dev, frames4)
    H4, W4 = frames4[0][0].shape
    (bargs4,) = [a for name, a in calls4 if name == "hme_base"]
    B4 = bargs4[0].shape[0]
    err = max_abs_err(hk.refine_base_cm(*bargs4), base_plain(bargs4))
    kern = lambda: hk.refine_base_cm(*bargs4)  # noqa: E731
    ms = cuda_ms(kern, 10)
    plain_ms = cuda_ms(lambda: base_plain(bargs4), 2)
    b_ms, b_by, b_extra = hme_bounds(work_hme_base(bargs4), bound)
    rows.append(row("hme_base_banded", "dsv1_tpu_torch/csrc/hme.cu",
                    "dsv1_tpu/ops/pallas_hme.py:662", err, ms, plain_ms,
                    b_ms, b_by, shape=f"4K B={B4} nb={enc4.nbh * enc4.nbv} "
                                      f"{enc4.blk_w}x{enc4.blk_h}",
                    device_ms=device_ms(kern, 10), **b_extra))
    mc_4k = check_mc(dev, enc4, imgs4, mv4, 12)
    del imgs4, mv4, calls4, bargs4
    err, ms, plain_ms, dev_ms, work, nintra = mc_1080
    err4, ms4, plain_ms4, dev_ms4, work4, nintra4 = mc_4k
    rows.append(row("mc", "dsv1_tpu_torch/csrc/mc.cu",
                    "dsv1_tpu/ops/pallas_mc.py:38", max(err, err4), ms,
                    plain_ms, *bound(*work),
                    shape="one 1080p frame, 3 planes (HME field); *_4k: "
                          "one 3840x2160 frame; errors also on a fuzzed "
                          "field", device_ms=dev_ms, intra_blocks=nintra,
                    ms_4k=ms4, plain_ms_4k=plain_ms4, device_ms_4k=dev_ms4,
                    bound_ms_4k=bound(*work4)[0], intra_blocks_4k=nintra4))

    # --- the Haar pyramid of one plane: 1080p luma P and I, 4K luma P,
    # and odd shapes past 6 levels (errors only)
    err_p, ms, plain_ms, dev_ms, work = check_haar(dev, H, W, True, 1)
    err_i, ms_i, plain_ms_i, dev_ms_i, work_i = check_haar(dev, H, W,
                                                           False, 2)
    err4, ms4, plain_ms4, dev_ms4, work4 = check_haar(dev, H4, W4, True, 3)
    err_odd = max(check_haar(dev, h, w, p, 4, timed=False)[0]
                  for h, w, p in ((130, 200, True), (70, 130, False),
                                  (300, 1, True), (1, 300, True),
                                  (84, 100, True), (540, 960, False)))
    rows.append(row("haar_fwd", "dsv1_tpu_torch/csrc/sbt.cu",
                    "tools/bench_haar.py:169",
                    max(err_p, err_i, err4, err_odd), ms, plain_ms,
                    *bound(*work),
                    shape=f"luma P pyramid {H}x{W} (levels 1..); "
                          f"*_i: I, levels 2..; *_4k: {H4}x{W4} P",
                    device_ms=dev_ms, ms_i=ms_i, plain_ms_i=plain_ms_i,
                    device_ms_i=dev_ms_i, bound_ms_i=bound(*work_i)[0],
                    ms_4k=ms4, plain_ms_4k=plain_ms4, device_ms_4k=dev_ms4,
                    bound_ms_4k=bound(*work4)[0]))
    torch.cuda.empty_cache()
    recon, cases = recon_rows(dev, bound, clips)
    rows += recon
    emit({"phase": "kernels", "recon_cases": cases})
    torch.cuda.empty_cache()
    rows.append(compact_rows(dev, bound))
    for r in rows:
        emit({"phase": "kernels", **r})
        if r["max_abs_err"] != 0:
            raise AssertionError(f"kernel {r['name']} disagrees with its "
                                 f"plain version")
    return rows


def check_mc_formats(dev, seed):
    """`mc` (predict_frame) against its plain version on 4:2:2 and 4:1:1
    frames, 96x80 and 1920x1080 with the encoder's blocks, each on a
    fuzzed field (random modes and submasks, MVs far
    past the plane edges): {format: max_abs_err}."""
    import numpy as np
    import torch

    import dsv1_tpu_torch as dt
    from dsv1_tpu_torch.models.encoder import block_geometry
    from dsv1_tpu_torch.ops import frame as fr, mc
    rng = np.random.default_rng(seed)
    errs = {}
    for tag, subsamp in (("422", dt.SUBSAMP_422), ("411", dt.SUBSAMP_411)):
        err = 0
        for w, h in ((96, 80), (1920, 1080)):
            bw, bh, nbh, nbv = block_geometry(w, h)
            layout = fr.make_layout(subsamp, w, h, True)
            img = torch.from_numpy(rng.integers(
                0, 256, layout.total, dtype=np.uint8)).to(dev)
            nb = nbh * nbv
            field = [torch.from_numpy(a.astype(np.int32)).to(dev) for a in (
                rng.integers(0, 2, nb), rng.integers(-4 * w, 4 * w, nb),
                rng.integers(-4 * h, 4 * h, nb), rng.integers(0, 16, nb))]
            geo = (layout, bw, bh, nbh, nbv)
            err = max(err, max_abs_err(mc.predict_frame(img, *geo, *field),
                                       mc.predict_frame_plain(img, *geo,
                                                              *field)))
        errs[tag] = err
    emit({"phase": "edges", "check": "mc_formats", "max_abs_err": errs})
    return errs


def phase_edges(dev):
    """The whole encode + decode on the GPU (kernels) and on the CPU
    (plain versions) must give the same bytes at geometries and modes
    the golden clips do not reach: partial right and bottom blocks,
    4:4:4, 4:2:2 and 4:1:1 chroma, per-frame and GOP-granular ABR.
    Returns `mc`'s errors on 4:2:2 and 4:1:1 frames."""
    import dsv1_tpu_torch as dt
    from dsv1_tpu_torch.utils import corpus
    from dsv1_tpu_torch.utils.stats import STATS

    def abr(quality=1900):
        return dt.EncoderConfig(gop=4, stable_refresh=3,
                                rc_mode=dt.RATE_CONTROL_ABR,
                                bitrate=300 * 1024, quality=quality,
                                max_quality=dt.MAX_QUALITY)

    crf = dt.EncoderConfig(gop=4, stable_refresh=3)
    cases = ((100, 84, dt.SUBSAMP_420, crf, "exact"),
             (96, 80, dt.SUBSAMP_444, crf, "exact"),
             (96, 80, dt.SUBSAMP_422, crf, "exact"),
             (96, 80, dt.SUBSAMP_411, abr(), "exact"),
             (96, 80, dt.SUBSAMP_420, abr(), "exact"),
             # GOP 0 overflows its caps at 2047, so the model calibrates
             # on GOP 1
             (96, 80, dt.SUBSAMP_422, abr(2047), "gop"))
    for w, h, subsamp, cfg, mode in cases:
        frames = corpus.split_frames(corpus.make_clip(w, h, subsamp, 8,
                                                      seed=5),
                                     w, h, subsamp, 8)
        meta = dt.Metadata(w, h, subsamp)
        verdicts = []
        for d in (dev, "cpu"):
            STATS.clear()
            verdicts.append((dt.encode_stream_gops(frames, meta, cfg,
                                                   device=d, abr_mode=mode),
                             STATS.get("calibration_gop"),
                             STATS["overflow_redos"]))
        (gpu, *v_gpu), (cpu, *v_cpu) = verdicts
        dg = dt.decode_stream_gops(gpu, device=dev)[1]
        dc = dt.decode_stream_gops(gpu, device="cpu")[1]
        same_dec = len(dg) == len(dc) == len(frames) and all(
            (a == b).all() for (_, pa), (_, pb) in zip(dg, dc)
            for a, b in zip(pa, pb))
        emit({"phase": "edges", "size": f"{w}x{h}", "subsamp": subsamp,
              "rc_mode": cfg.rc_mode, "abr_mode": mode,
              "calibration_gop": v_gpu[0], "overflow_redos": v_gpu[1],
              "stream_equal": gpu == cpu, "decode_equal": bool(same_dec)})
        if gpu != cpu or not same_dec or v_gpu != v_cpu:
            raise AssertionError(f"{w}x{h}: GPU and CPU paths disagree")
    return check_mc_formats(dev, 17)


def tiled_haar(cw: int, ch: int, D: int, first: int) -> int:
    """`haar_fwd` launches of one forward transform of a (cw, ch) plane
    (or a batch of them) in D column tiles (parallel/tile.py): per tile
    one pyramid call for its levels first..m (m = the tiled levels), and
    one for the gathered tail m+1.., each launching twice past
    HAAR_TILE_LEVELS levels; with no tiled level, the untiled call."""
    from dsv1_tpu_torch.ops import sbt
    from dsv1_tpu_torch.parallel import tile

    def call(lo, hi):
        return (1 + (hi - lo + 1 > sbt.HAAR_TILE_LEVELS)) if lo <= hi else 0
    lv = sbt.nlevels(cw, ch)
    m = tile._tiled_levels(cw, ch, D) if D > 1 else 0
    if m == 0:
        return call(first, lv)
    return D * call(first, m) + call(m + 1, lv)


def tiled_whole(cw: int, ch: int, D: int) -> bool:
    """Whether a (cw, ch) plane's transforms in D column tiles run as the
    untiled functions (no level splits into whole column pairs a tile:
    parallel/tile.py `_tiled_levels` 0), and so on the B4T and inverse
    kernels; the tiled levels run eager."""
    from dsv1_tpu_torch.parallel import tile
    return D == 1 or tile._tiled_levels(cw, ch, D) == 0


def predict_launches(stats, w: int, h: int, tiles: int = 1) -> dict:
    """Each kernel's launches on a path of one geometry, from what the
    path did (utils/stats.py STATS) and each wrapper's launches per call:
    `mc` one per call of the encode core on P frames (a frame, or the P
    frames of one frame index of a chunk's GOPs) and one per MC call of
    the decoders (the P pictures of one frame index of a chunk of
    chains, or a picture of the sequential Decoder), `haar_fwd` per call
    of the core one C call for each plane with a Haar level (levels 1..
    of a P plane, 2.. of an intra plane; the call covers the batch),
    which launches twice past HAAR_TILE_LEVELS levels, or with `tiles`
    column tiles (a gop x tile encode) `tiled_haar`'s count; per
    `hme_batch` call (one a chunk) at
    effort 0 `hme_base` once and `hme_refine` levels + 1 times (a kernel
    per coarse level, then the candidates) at the auto pyramid depth,
    and per call at effort 1..3 `hme_refine` levels + 2 times (level 0
    too; its level-0 launch also counts as `hme_refine_level0`) and
    `hme_wide` once. The recon chain: per call of the core
    `residual_in` once (the three planes), `hzcc_quant` once a plane,
    `b4t_fwd` once a plane of an intra call, and where the core
    reconstructs, `inv_sbt` `sbt.inv_plan`'s launches a plane; per
    decoder reconstruction (`decode_calls`) `hzcc_dequant` once and
    `inv_sbt` `inv_plan`'s launches a plane. In column tiles the B4T and
    the inverse run on their kernels only for planes whose transforms
    are not split (`tiled_whole`). `hzcc_compact` three launches per
    chunk of the GOP path or of gop 0 whose compaction overflowed
    (`overflow_exact`)."""
    from dsv1_tpu_torch.models.encoder import (auto_pyramid_levels,
                                               block_geometry, coef_geometry)
    from dsv1_tpu_torch.constants import SUBSAMP_420
    from dsv1_tpu_torch.ops import sbt
    _bw, _bh, nbh, nbv = block_geometry(w, h)
    levels = auto_pyramid_levels(w, h, nbh, nbv)
    dims = coef_geometry(SUBSAMP_420, w, h, nbh, nbv)[1]

    def haar(first):
        return sum(tiled_haar(cw, ch, tiles, first) for cw, ch in dims)

    whole = [tiled_whole(cw, ch, tiles) for cw, ch in dims]
    inv = [sbt.inv_plan(cw, ch)[2] for cw, ch in dims]
    core = stats.get("core_calls_i", 0) + stats.get("core_calls_p", 0)
    dec = stats.get("decode_calls", 0)
    return {"mc": stats.get("core_calls_p", 0)
            + stats.get("decode_p_calls", 0),
            "residual_in": core,
            "b4t_fwd": stats.get("core_calls_i", 0) * sum(whole),
            "hzcc_quant": 3 * core,
            "hzcc_dequant": 3 * dec,
            "inv_sbt": stats.get("core_calls_recon", 0)
            * sum(n for n, k in zip(inv, whole) if k) + dec * sum(inv),
            "haar_fwd": stats.get("core_calls_i", 0) * haar(2)
            + stats.get("core_calls_p", 0) * haar(1),
            "hme_base": stats.get("hme_calls", 0),
            "hme_refine": stats.get("hme_calls", 0) * (levels + 1)
            + stats.get("hme_calls_wide", 0) * (levels + 2),
            "hme_refine_level0": stats.get("hme_calls_wide", 0),
            "hme_wide": stats.get("hme_calls_wide", 0),
            "hzcc_compact": 3 * stats.get("overflow_exact", 0)}


def check_predicted(path, launches, stats, w, h, tiles=1):
    """The path's launch counts equal predict_launches'; returns the
    prediction."""
    want = predict_launches(stats, w, h, tiles)
    got = {k: launches.get(k, 0) for k in KERNELS}
    if got != want:
        raise AssertionError(f"{path}: launches {got}, predicted {want} "
                             f"from {dict(stats)}")
    return want


def check_launches(path, launches, kernels=BASE_PATH,
                   absent=("hme_wide",)):
    """Every kernel of `kernels` launched on the path, none of
    `absent`."""
    for k in kernels:
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"kernel {k} was not launched on the "
                                 f"{path} path")
    for k in absent:
        if launches.get(k, 0):
            raise AssertionError(f"kernel {k} was launched on the {path} "
                                 "path")


def phase_slice(dev, smi, golden, clips):
    """Main path 1: encode + decode both CRF golden clips on the GPU."""
    import torch

    import dsv1_tpu_torch as dt
    from dsv1_tpu_torch.kernels.build import LAUNCHES
    from dsv1_tpu_torch.utils.golden import GOP, QUALITY_PCT, decoded_bytes
    from dsv1_tpu_torch.utils.stats import STATS

    results = []
    launches = {}
    for name in SLICE_CLIPS:
        gold = golden[name]
        yuv, frames = clips[name]
        if sha(yuv) != gold["clip_sha256"]:
            raise AssertionError(f"{name}: input clip differs from the "
                                 "golden clip")
        meta = dt.Metadata(gold["width"], gold["height"], dt.SUBSAMP_420)
        cfg = dt.EncoderConfig(quality=dt.quality_percent(QUALITY_PCT),
                               gop=GOP, stable_refresh=GOP - 1)
        torch.cuda.synchronize()
        LAUNCHES.clear()
        STATS.clear()
        for _rep in range(ENCODE_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stream = dt.encode_stream_gops(frames, meta, cfg, device=dev)
            t_enc = time.perf_counter() - t0
            if sha(stream) != gold["stream_sha256"]:
                raise AssertionError(f"{name}: stream differs from golden")
            t0 = time.perf_counter()
            _m, dec = dt.decode_stream_gops(stream, device=dev)
            t_dec = time.perf_counter() - t0
            if sha(decoded_bytes(dec)) != gold["decode_sha256"]:
                raise AssertionError(f"{name}: decode differs from golden")
        n = len(frames)
        got = dict(LAUNCHES)
        check_predicted(name, got, STATS, gold["width"], gold["height"])
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        res = {"phase": "slice", "clip": name,
               "size": f"{gold['width']}x{gold['height']}",
               "frames": n, "stream_bytes": len(stream),
               "stream_sha256_ok": True, "decode_sha256_ok": True,
               "encode_fps": n / t_enc, "decode_fps": n / t_dec,
               "launches": got, "launches_as_predicted": True,
               "overflow_redos": STATS["overflow_redos"], "card": smi}
        if name == "1080p":
            # kernels per frame and the busy share (outside the counts)
            res.update(metrics_encode=run_metrics(lambda: (
                dt.encode_stream_gops(frames, meta, cfg, device=dev)), n),
                metrics_decode=run_metrics(lambda: (
                    dt.decode_stream_gops(stream, device=dev)), n))
        results.append(res)
    for r in results:
        emit(r)
    emit({"phase": "slice", "launches": launches})
    check_launches("slice", launches, BASE_PATH + DEC_RECON)
    return launches


def phase_cli(dev, smi, golden, clips):
    """Main path 2: the CLI's default encode and decode, through files,
    of the CIF and 4K CLI clips; then -gopabr1 on the 1080p clip. Returns
    the launches per clip."""
    import torch

    from dsv1_tpu_torch import cli
    from dsv1_tpu_torch.kernels.build import LAUNCHES
    from dsv1_tpu_torch.utils.golden import cli_decode_args, cli_encode_args
    from dsv1_tpu_torch.utils.stats import STATS

    per_path = {}
    with tempfile.TemporaryDirectory() as td:
        for name in CLI_CLIPS:
            gold = golden[name]
            yuv, _frames = clips[name]
            if sha(yuv) != gold["clip_sha256"]:
                raise AssertionError(f"{name}: input clip differs from the "
                                     "golden clip")
            inp, dsv, out = (Path(td) / f for f in ("in.yuv", "s.dsv",
                                                     "o.yuv"))
            inp.write_bytes(yuv)
            torch.cuda.synchronize()
            LAUNCHES.clear()
            STATS.clear()
            t0 = time.perf_counter()
            if cli.main(cli_encode_args(name, inp, dsv), device=dev) != 0:
                raise AssertionError(f"{name}: CLI encode failed")
            t_enc = time.perf_counter() - t0
            enc_stats = dict(STATS)
            t0 = time.perf_counter()
            if cli.main(cli_decode_args(dsv, out), device=dev) != 0:
                raise AssertionError(f"{name}: CLI decode failed")
            t_dec = time.perf_counter() - t0
            per_path[name] = dict(LAUNCHES)
            stream = dsv.read_bytes()
            ok_s = sha(stream) == gold["stream_sha256"]
            ok_d = sha(out.read_bytes()) == gold["decode_sha256"]
            n = gold["frames"]
            res = {"phase": "cli", "clip": name,
                   "size": f"{gold['width']}x{gold['height']}",
                   "frames": n, "argv": gold["argv"],
                   "stream_bytes": len(stream), "stream_sha256_ok": ok_s,
                   "decode_sha256_ok": ok_d, "encode_fps": n / t_enc,
                   "decode_fps": n / t_dec, "launches": per_path[name],
                   "predicted_launches": predict_launches(
                       STATS, gold["width"], gold["height"]),
                   "overflow_redos": enc_stats.get("overflow_redos", 0),
                   "encode_stats": enc_stats, "card": smi}
            emit(res)
            if not (ok_s and ok_d):
                raise AssertionError(f"{name}: CLI stream or decode "
                                     "differs from golden")
            check_launches(name, per_path[name], BASE_PATH + DEC_RECON)
            check_predicted(name, per_path[name], STATS, gold["width"],
                            gold["height"])
            if name == GOPABR_CLIP:
                # None: every GOP overflowed its caps, so the rate model
                # was never calibrated (as in the JAX package)
                emit({"phase": "cli", "clip": name,
                      "calibration_gop": enc_stats.get("calibration_gop"),
                      "overflow_redos": enc_stats.get("overflow_redos", 0)})
    return per_path


def check_seq_hme(dev, frames, effort=0):
    """The HME kernels against their plain versions on the B = 1
    arguments the sequential Encoder passes at `effort` for the second
    frame of a clip (a P frame): `refine_coarse`, then at effort 0
    `refine_base_cm`, else `refine_level` at level 0 and `refine_wide`
    (the [None] views of trap 5: word alignment at B = 1), `refine_wide`
    at efforts 1, 2 and 3 on the `pre` of `effort`. Prints per kernel
    the error, the CUDA-event ms and the device-only ms; returns the
    errors by kernel."""
    import dsv1_tpu_torch as dt
    from dsv1_tpu_torch.ops import hme_kernels as hk
    h, w = frames[0][0].shape
    enc = dt.Encoder(dt.Metadata(w, h, dt.SUBSAMP_420),
                     dt.EncoderConfig(gop=12, stable_refresh=11,
                                      effort=effort), device=dev)
    enc.start()
    calls = []
    for f in frames[:2]:
        enc.encode(f, calls=calls)
    args = dict(calls)
    if len(args) != len(calls):
        raise AssertionError(f"more than one P frame's calls: {calls}")
    kerns = [("hme_refine", "hme_coarse", hk.refine_coarse,
              hk.refine_coarse_plain)]
    kerns += [("hme_base", "hme_base", hk.refine_base_cm,
               lambda *a: base_plain(a))] \
        if effort == 0 else \
        [("hme_refine_level0", "hme_level0", hk.refine_level,
          hk.refine_level_plain),
         ("hme_wide", "hme_wide", hk.refine_wide, hk.refine_wide_plain)]
    out = {"phase": "effort" if effort else "sequential", "check": "hme_b1",
           "shape": f"{w}x{h} B={args['hme_coarse'][0][0].shape[0]} "
                    f"levels {enc._levels} effort {effort}"}
    for name, call, kern, plain in kerns:
        a = args[call]
        out[name] = {"max_abs_err": max_abs_err(kern(*a), plain(*a)),
                     "ms": cuda_ms(lambda: kern(*a), 20),
                     "device_ms": device_ms(lambda: kern(*a), 20)}
        if name == "hme_wide":
            out[name]["max_abs_err"] = max(
                max_abs_err(kern(*a[:-1], e), plain(*a[:-1], e))
                for e in (1, 2, 3))
    emit(out)
    for name, *_ in kerns:
        if out[name]["max_abs_err"] != 0:
            raise AssertionError(f"kernel {name} disagrees with its plain "
                                 f"version at B = 1, effort {effort}")
    return {name: out[name]["max_abs_err"] for name, *_ in kerns}


def phase_sequential(dev, smi, golden, clips):
    """Main path 3: the sequential Encoder and Decoder and the gop-0
    encode, through the CLI and files (and the Decoder through the API)
    on the two 1080p sequential clips. Returns the launches summed over
    the phase's paths."""
    import torch

    import dsv1_tpu_torch as dt
    from dsv1_tpu_torch import cli
    from dsv1_tpu_torch.kernels.build import LAUNCHES
    from dsv1_tpu_torch.utils.golden import (CLIPS, cli_decode_args,
                                             cli_encode_args, decoded_bytes)
    from dsv1_tpu_torch.utils.stats import STATS

    check_seq_hme(dev, clips[SEQ_CLIP][1])
    total = {}
    redos = {}

    def run(path, fn, kernels=(), absent=()):
        """fn() with the counts set to 0: (seconds, launches, result);
        the clip of the path is the loop's `gold`."""
        torch.cuda.synchronize()
        LAUNCHES.clear()
        STATS.clear()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        dt_s = time.perf_counter() - t0
        got = dict(LAUNCHES)
        check_launches(path, got, kernels, absent)
        check_predicted(path, got, STATS, gold["width"], gold["height"])
        redos[path] = STATS["overflow_redos"]
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        return dt_s, got, result

    def cli_ok(argv):
        if cli.main(argv, device=dev) != 0:
            raise AssertionError(f"CLI {argv[0]} failed: {argv}")

    with tempfile.TemporaryDirectory() as td:
        inp, dsv, out = (Path(td) / f for f in ("in.yuv", "s.dsv", "o.yuv"))
        for name, enc_kernels, enc_absent in (
                (SEQ_CLIP, BASE_PATH, ("hme_wide",)),
                (GOP0_CLIP, ("haar_fwd", "residual_in", "b4t_fwd",
                              "hzcc_quant"),
                 ("mc", "hme_refine", "hme_base", "hme_wide", "inv_sbt"))):
            gold = golden[name]
            yuv, _frames = clips[name]
            if sha(yuv) != gold["clip_sha256"]:
                raise AssertionError(f"{name}: input clip differs from the "
                                     "golden clip")
            inp.write_bytes(yuv)
            n = gold["frames"]
            t_enc, l_enc, _ = run(f"{name} encode", lambda: cli_ok(
                cli_encode_args(name, inp, dsv)), enc_kernels, enc_absent)
            stream = dsv.read_bytes()
            res = {"phase": "sequential", "clip": name,
                   "size": f"{gold['width']}x{gold['height']}", "frames": n,
                   "argv": gold["argv"], "stream_bytes": len(stream),
                   "stream_sha256_ok": sha(stream) == gold["stream_sha256"],
                   "encode_fps": n / t_enc, "encode_launches": l_enc,
                   "launches_as_predicted": True,
                   "overflow_redos": redos[f"{name} encode"]}
            t_dec, _, _ = run(f"{name} decode", lambda: cli_ok(
                cli_decode_args(dsv, out)), DEC_RECON)
            res.update(decode_sha256_ok=sha(out.read_bytes())
                       == gold["decode_sha256"], decode_fps=n / t_dec)
            for key, extra in CLIPS[name][5].items():
                tag = key.replace("_sha256", "")
                t_x, l_x, _ = run(f"{name} {tag}", lambda: cli_ok(
                    cli_decode_args(dsv, out, extra)), DECODE_PATH)
                res.update({f"{key}_ok": sha(out.read_bytes()) == gold[key],
                            f"{tag}_fps": n / t_x, f"{tag}_launches": l_x})
            if name == SEQ_CLIP:
                t_api, l_api, dec = run(f"{name} Decoder", lambda: list(
                    dt.Decoder(device=dev).decode_stream(stream)),
                    DECODE_PATH)
                res.update(api_decode_sha256_ok=sha(decoded_bytes(dec))
                           == gold["decode_sha256"],
                           api_decode_fps=n / t_api, api_decode_launches=l_api)
            res["card"] = smi
            emit(res)
            bad = [k for k, v in res.items() if k.endswith("_ok") and not v]
            if bad:
                raise AssertionError(f"{name}: {bad} differ from the golden")
    # gop 0 at UHD, where every frame overflows the I cap: the exact
    # compaction of encode_stream_gops against the sequential Encoder's
    # dense read of the same frames
    gold = {"width": 3840, "height": 2160}
    frames = clips["4k_cli"][1][:UHD_GOP0_FRAMES]
    meta, cfg, _abr = cli.encode_config(["-w3840", "-h2160", "-gop0",
                                         "-rc_mode1"])
    intra_path = ("haar_fwd", "residual_in", "b4t_fwd", "hzcc_quant")
    t_par, l_par, stream = run(
        "4k_gop0 encode_stream_gops",
        lambda: dt.encode_stream_gops(frames, meta, cfg, dev),
        intra_path + ("hzcc_compact",),
        ("mc", "hme_refine", "hme_base", "hme_wide", "inv_sbt"))
    st = dict(STATS)

    def sequential():
        enc = dt.Encoder(meta, cfg, device=dev)
        enc.start()
        return enc.encode_stream(frames)
    t_seq, l_seq, want = run("4k_gop0 Encoder", sequential, intra_path,
                             ("hzcc_compact",))
    res = {"phase": "sequential", "clip": "4k_gop0",
           "size": "3840x2160", "frames": len(frames),
           "argv": ["-gop0", "-rc_mode1"], "stream_bytes": len(stream),
           "stream_equals_encoder_ok": stream == want,
           "every_chunk_exact_ok": st.get("overflow_exact", 0)
           == st.get("overflow_redos", 0) == st.get("intra_chunks", 0)
           == len(frames),
           "overflow_syms": st.get("overflow_syms", 0),
           "no_dense_read_ok": not st.get("intra_dense_bytes", 0),
           "encode_fps": len(frames) / t_par,
           "encoder_fps": len(frames) / t_seq,
           "encode_launches": l_par, "encoder_launches": l_seq,
           "launches_as_predicted": True,
           "d2h_bytes": st.get("d2h_bytes", 0),
           "host_reads": st.get("host_reads", 0), "card": smi}
    emit(res)
    bad = [k for k, v in res.items() if k.endswith("_ok") and not v]
    if bad:
        raise AssertionError(f"4k_gop0: {bad} failed")
    emit({"phase": "sequential", "launches": total})
    return total


def check_effort_kernels(dev, frames, seed):
    """Kernel #2 at level 0 and `refine_wide` against their plain
    versions on the first GOP of a clip at effort 3: on `hme_batch`'s
    own arguments, and on edge candidates and an edge `pre`; the wide
    search at efforts 1, 2 and 3 on both `pre`. Returns (level-0 error,
    wide error, the level-0 and wide arguments, the encoder)."""
    import numpy as np

    from dsv1_tpu_torch.ops import hme_kernels as hk
    from dsv1_tpu_torch.utils.edges import edge_cands, edge_pre
    enc, _imgs, _mv, calls = gop_motion(dev, frames, effort=3)
    (largs,) = [a for name, a in calls if name == "hme_level0"]
    (wargs,) = [a for name, a in calls if name == "hme_wide"]
    rng = np.random.default_rng(seed)
    B = largs[0].shape[0]
    p = enc.layouts[0].planes[0]
    geo = (enc.nbh, enc.nbv, p.w, p.h, enc.blk_w, enc.blk_h)
    fl = (*largs[:3], *edge_cands(rng, dev, B, *geo, p.ext), *largs[5:])
    err_l = max(max_abs_err(hk.refine_level(*a), hk.refine_level_plain(*a))
                for a in (largs, fl))
    err_w = 0
    for pre in (wargs[7], edge_pre(rng, dev, B, *geo)):
        for effort in (1, 2, 3):
            a = (*wargs[:7], pre, effort)
            err_w = max(err_w, max_abs_err(hk.refine_wide(*a),
                                           hk.refine_wide_plain(*a)))
    return err_l, err_w, largs, wargs, enc


def wide_cut(wargs, pre, effort, head, n):
    """`hme_wide`'s kernel on images cut to n bytes from byte `head` of
    each pair's flat image (one direct call, not counted as a launch),
    and `refine_wide_plain` on the same cut images: windows past the
    cut ends read its first or last chunk. Returns the largest error."""
    import dataclasses

    import torch

    from dsv1_tpu_torch.kernels.build import launch
    from dsv1_tpu_torch.ops import hme_kernels as hk
    src, ref, lay, nbh_l, nb, BW, BH, _pre, _e = wargs
    _, _, pstride, EH, S, E, w, h = hk._planes(src, ref, lay, BW, BH)
    B = src.shape[0]
    org = lay.margin + lay.planes[0].offset - head
    outs = [torch.empty((B, nb), dtype=torch.int32, device=src.device)
            for _ in range(6)]
    launch("dsv1_hme_wide", src, src.data_ptr() + head,
           ref.data_ptr() + head, pstride, n, org, EH, S, E, w, h,
           hk.chunk_width(S).bit_length() - 1, nbh_l, nb, BW, BH, effort, B,
           *[t.data_ptr() for t in pre], *[o.data_ptr() for o in outs])
    cut = dataclasses.replace(lay, margin=lay.margin - head)
    want = hk.refine_wide_plain(src[:, head:head + n], ref[:, head:head + n],
                                cut, nbh_l, nb, BW, BH, pre, effort)
    return max_abs_err(tuple(outs), want)


def check_wide_cases(dev, clips, wargs, seed):
    """`refine_wide` against its plain version beyond the main path's
    1080p and 4K GOPs, at efforts 1, 2 and 3: on CIF's 16x16 blocks and
    on a 1918x1078 clip (the right block column partial, its width not a
    word multiple), each on the encoder's `pre` and an edge `pre`; and
    on the 1080p GOP's images (wargs) cut 48 rows above and below the
    frame, so that the edge `pre`'s windows reach the image's first and
    last chunk while its half-pel neighbourhoods stay inside (that some
    windows reach past each end is checked). Prints the errors by case;
    returns the largest."""
    import numpy as np
    import torch

    import dsv1_tpu_torch as dt
    from dsv1_tpu_torch.ops import hme_kernels as hk
    from dsv1_tpu_torch.utils import corpus
    from dsv1_tpu_torch.utils.edges import edge_pre
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    w, h, n = 1918, 1078, 3
    odd = corpus.split_frames(corpus.make_clip(w, h, dt.SUBSAMP_420, n,
                                               seed=seed), w, h,
                              dt.SUBSAMP_420, n)
    errs = {}
    for tag, frames, G in (("cif 16x16", clips["cif"][1], None),
                           ("1918x1078", odd, n)):
        enc, _imgs, _mv, calls = gop_motion(dev, frames, G, effort=3)
        (a,) = [x for name, x in calls if name == "hme_wide"]
        p = enc.layouts[0].planes[0]
        ep = edge_pre(rng, dev, a[0].shape[0], enc.nbh, enc.nbv, p.w, p.h,
                      enc.blk_w, enc.blk_h)
        errs[tag] = max(max_abs_err(hk.refine_wide(*a[:7], pre, e),
                                    hk.refine_wide_plain(*a[:7], pre, e))
                        for pre in (a[7], ep) for e in (1, 2, 3))
    src, _ref, lay, nbh_l, nb, BW, BH, _pre, _e = wargs
    p = lay.planes[0]
    head = lay.margin + p.offset - (48 * p.stride + p.ext)
    n_cut = 48 * p.stride + p.ext + (p.h + 48) * p.stride
    ep = edge_pre(rng, dev, src.shape[0], nbh_l, nb // nbh_l, p.w, p.h, BW,
                  BH)
    errs["1080p cut to 48 rows around the frame"] = max(
        wide_cut(wargs, ep, e, head, n_cut) for e in (1, 2, 3))
    # the windows whose bytes lie before the cut image or past its last
    # whole chunk: only the chunk clip reads them as the plain version
    # does, so their agreement above holds the kernel's clipped reads
    t = torch.arange(nb)
    bx, by = t % nbh_l * BW, t // nbh_l * BH
    bw_c, bh_c = (p.w - bx).clamp(0, BW), (p.h - by).clamp(0, BH)
    dx0, dy0 = (x.cpu().to(torch.int64) for x in ep[:2])
    whole = n_cut // hk.chunk_width(p.stride) * hk.chunk_width(p.stride)
    clipped = {}
    for e in (1, 2, 3):
        f0 = (48 * p.stride + p.ext + (by + dy0 - 2 * e) * p.stride
              + bx + dx0 - 2 * e)
        end = f0 + (bh_c + 4 * e - 1) * p.stride + bw_c + 4 * e
        clipped[e] = (int((f0 < 0).sum()), int((end > whole).sum()))
        if min(clipped[e]) == 0:
            raise AssertionError(f"effort {e}: no window of the cut images "
                                 "reaches one of their ends")
    emit({"phase": "effort", "check": "hme_wide_cases", "errors": errs,
          "windows_past_first_last_chunk": clipped,
          "seconds": time.perf_counter() - t0})
    return max(errs.values())


def effort_rows(dev, bound, clips):
    """The kernel rows of kernel #2 at level 0 and of `hme_wide`: errors
    at 1080p and 4K (check_effort_kernels), at B = 1 on the sequential
    Encoder's arguments (check_seq_hme at effort 2) and, for `hme_wide`,
    on CIF, 1918x1078 and cut images (check_wide_cases), times and
    bounds on the 1080p GOP's arguments at effort 3, the 4K times beside
    them."""
    from dsv1_tpu_torch.ops import hme_kernels as hk
    b1 = check_seq_hme(dev, clips[EFFORT_SEQ_CLIP][1], effort=2)
    out = {}
    for tag, clip, seed in (("1080p", "1080p_effort_cli", 21),
                            ("4k", "4k_effort_cli", 22)):
        err_l, err_w, largs, wargs, enc = check_effort_kernels(
            dev, clips[clip][1], seed)
        if tag == "1080p":
            err_w = max(err_w, check_wide_cases(dev, clips, wargs, 23))
        reps = 20 if tag == "1080p" else 10
        lk = lambda: hk.refine_level(*largs)  # noqa: E731
        wk = lambda: hk.refine_wide(*wargs)  # noqa: E731
        out[tag] = {
            "err_l": err_l, "err_w": err_w,
            "l": (cuda_ms(lk, reps), device_ms(lk, reps),
                  cuda_ms(lambda: hk.refine_level_plain(*largs), 2),
                  hme_bounds(work_hme_level(largs), bound)),
            "w": (cuda_ms(wk, reps), device_ms(wk, reps),
                  cuda_ms(lambda: hk.refine_wide_plain(*wargs), 2),
                  hme_bounds(work_hme_wide(wargs), bound)),
            "w12": [cuda_ms(lambda e=e: hk.refine_wide(*wargs[:-1], e), reps)
                    for e in (1, 2)],
            "shape": f"B={largs[0].shape[0]} nb={enc.nbh * enc.nbv} "
                     f"{enc.blk_w}x{enc.blk_h}"}
    rows = []
    for name, key, replaces in (
            ("hme_refine_level0", "l", "dsv1_tpu/ops/pallas_hme.py:130"),
            ("hme_wide", "w", "dsv1_tpu/ops/hme.py:324 (XLA refine_base "
                              "with pre, effort > 0; no Pallas kernel)")):
        e1, e4 = out["1080p"], out["4k"]
        ms, dev_ms, plain_ms, (b_ms, b_by, b_extra) = e1[key]
        ms4, dev_ms4, plain_ms4, (b_ms4, _by, _x) = e4[key]
        err = max(e1["err_" + key], e4["err_" + key], b1[name])
        extra = {"ms_effort1_2": e1["w12"], "ms_4k_effort1_2": e4["w12"]} \
            if key == "w" else {}
        rows.append(row(name, "dsv1_tpu_torch/csrc/hme.cu", replaces, err,
                        ms, plain_ms, b_ms, b_by,
                        shape=f"1080p GOP {e1['shape']}, effort 3; *_4k: "
                              f"4K GOP {e4['shape']}; errors also on edge "
                              "inputs, at B = 1 (sequential Encoder, "
                              "effort 2) and, for hme_wide, efforts 1 and "
                              "2, B = 1 at every effort, CIF 16x16, "
                              "1918x1078 and cut images",
                        device_ms=dev_ms, ms_4k=ms4, device_ms_4k=dev_ms4,
                        plain_ms_4k=plain_ms4, bound_ms_4k=b_ms4,
                        **b_extra, **extra))
    for r in rows:
        emit({"phase": "effort", **r})
        if r["max_abs_err"] != 0:
            raise AssertionError(f"kernel {r['name']} disagrees with its "
                                 "plain version")
    return rows


def check_recon(path, last, recon, layout):
    """A decoder's last frame `last` (y, u, v) equals the Encoder's
    reconstruction of it (`recon`, a flat image in `layout`)."""
    import numpy as np

    from dsv1_tpu_torch.ops import frame as fr
    want = [fr.plane_view(recon, layout, c).cpu().numpy() for c in range(3)]
    if not all(np.array_equal(np.asarray(a), b) for a, b in zip(last, want)):
        raise AssertionError(f"{path}: the decoded last frame differs from "
                             "the encoder's reconstruction")


def check_seq_recon(dev, frames, effort):
    """Both decoders' last frame (the sequential `Decoder` and
    `iter_decode_gops`) against the sequential Encoder's reconstruction
    of it, on a CRF encode of the clip at `effort` through the API."""
    import torch

    import dsv1_tpu_torch as dt
    from dsv1_tpu_torch.ops import frame as fr
    from dsv1_tpu_torch.utils.golden import GOP, QUALITY_PCT
    h, w = frames[0][0].shape
    enc = dt.Encoder(dt.Metadata(w, h, dt.SUBSAMP_420), dt.EncoderConfig(
        quality=dt.quality_percent(QUALITY_PCT), gop=GOP,
        stable_refresh=GOP - 1, effort=effort), device=dev)
    enc.start()
    stream = enc.encode_stream(frames)
    recon = torch.from_numpy(enc.state_dict()["ref_recon"])
    lay = fr.make_layout(dt.SUBSAMP_420, w, h, True)
    for path, dec in (
            ("Decoder", list(dt.Decoder(device=dev).decode_stream(stream))),
            ("iter_decode_gops", list(dt.iter_decode_gops(stream,
                                                          device=dev)))):
        check_recon(f"{w}x{h} effort {effort} {path}", dec[-1][1], recon,
                    lay)
    emit({"phase": "effort", "check": "decoders_match_encoder_recon",
          "size": f"{w}x{h}", "frames": len(frames), "effort": effort,
          "ok": True})


def phase_effort(dev, bound, smi, golden, clips):
    """Main path 4: the wider level-0 search (effort 1..3). First kernel
    #2 at level 0 and `hme_wide` against their plain versions
    (effort_rows), and both decoders' last frame against the sequential
    Encoder's reconstruction on `1080p_effort_seq_cli`'s clip
    (check_seq_recon); then the three effort clips through the CLI and
    files on the card, each encode and decode against its golden and
    its launches against the prediction (`hme_base` absent, `hme_wide`
    present), and `1080p_effort_seq_cli` also through the `Decoder`
    API. Returns (rows, the launches summed over the phase's paths)."""
    import torch

    import dsv1_tpu_torch as dt
    from dsv1_tpu_torch import cli
    from dsv1_tpu_torch.kernels.build import LAUNCHES
    from dsv1_tpu_torch.utils.golden import (cli_decode_args,
                                             cli_encode_args, decoded_bytes)
    from dsv1_tpu_torch.utils.stats import STATS

    rows = effort_rows(dev, bound, clips)
    check_seq_recon(dev, clips[EFFORT_SEQ_CLIP][1], 2)
    total = {}

    def run(path, fn, w, h, kernels=(), absent=()):
        torch.cuda.synchronize()
        LAUNCHES.clear()
        STATS.clear()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = dict(LAUNCHES)
        check_launches(path, got, kernels, absent)
        check_predicted(path, got, STATS, w, h)
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        return secs, got, dict(STATS), result

    def cli_ok(argv):
        if cli.main(argv, device=dev) != 0:
            raise AssertionError(f"CLI {argv[0]} failed: {argv}")

    with tempfile.TemporaryDirectory() as td:
        inp, dsv, out = (Path(td) / f for f in ("in.yuv", "s.dsv", "o.yuv"))
        for name in EFFORT_CLIPS:
            gold = golden[name]
            w, h, n = gold["width"], gold["height"], gold["frames"]
            yuv, _frames = clips[name]
            if sha(yuv) != gold["clip_sha256"]:
                raise AssertionError(f"{name}: input clip differs from the "
                                     "golden clip")
            inp.write_bytes(yuv)
            t_enc, l_enc, st, _ = run(
                f"{name} encode", lambda: cli_ok(cli_encode_args(
                    name, inp, dsv)), w, h, WIDE_PATH, ("hme_base",))
            stream = dsv.read_bytes()
            t_dec, l_dec, _, _ = run(f"{name} decode", lambda: cli_ok(
                cli_decode_args(dsv, out)), w, h, DECODE_PATH)
            res = {"phase": "effort", "clip": name, "size": f"{w}x{h}",
                   "frames": n, "argv": gold["argv"],
                   "stream_bytes": len(stream),
                   "stream_sha256_ok": sha(stream) == gold["stream_sha256"],
                   "decode_sha256_ok": sha(out.read_bytes())
                   == gold["decode_sha256"],
                   "encode_fps": n / t_enc, "decode_fps": n / t_dec,
                   "encode_launches": l_enc, "decode_launches": l_dec,
                   "launches_as_predicted": True,
                   "hme_calls_wide": st.get("hme_calls_wide", 0),
                   "overflow_redos": st.get("overflow_redos", 0)}
            if name == EFFORT_SEQ_CLIP:
                t_api, l_api, _, dec = run(f"{name} Decoder", lambda: list(
                    dt.Decoder(device=dev).decode_stream(stream)), w, h,
                    DECODE_PATH)
                res.update(api_decode_sha256_ok=sha(decoded_bytes(dec))
                           == gold["decode_sha256"],
                           api_decode_fps=n / t_api,
                           api_decode_launches=l_api)
            res["card"] = smi
            emit(res)
            bad = [k for k, v in res.items() if k.endswith("_ok") and not v]
            if bad:
                raise AssertionError(f"{name}: {bad} differ from the golden")
    emit({"phase": "effort", "launches": total})
    return rows, total


def chunk_motion(dev, frames, C):
    """The first C GOPs of a clip (gop 12, qp 85) as one chunk through
    `GopEncoder.motion`: (encoder, images (C * 12, flat) per level, the
    motion dict over the C * 11 P slots)."""
    import numpy as np
    import torch

    import dsv1_tpu_torch as dt
    from dsv1_tpu_torch.parallel.gop import build_gop_encoder
    from dsv1_tpu_torch.utils.golden import GOP, QUALITY_PCT

    h, w = frames[0][0].shape
    enc = build_gop_encoder(dt.SUBSAMP_420, w, h, GOP,
                            dt.quality_percent(QUALITY_PCT), True, 4, 50,
                            GOP - 1, 0, str(dev), None, 0)
    rows = np.stack([np.concatenate([np.asarray(p, np.uint8).ravel()
                                     for p in f]) for f in frames[:C * GOP]])
    packed = torch.from_numpy(rows.reshape(C, GOP, -1)).to(dev)
    imgs, _al, mv, _hr = enc.motion(packed)
    return enc, imgs, mv


def check_mc_batch(dev, enc, imgs, mv, C, seed):
    """`mc` on a batch: the P frames of one frame index of a chunk's C
    GOPs (the index with the most intra blocks; each GOP's previous input
    frame as its reference) in one call, against the plain version and
    against C single-frame calls, on the HME fields and on fuzzed ones
    (random modes and submasks, MVs far past the plane edges). Times
    (CUDA events, device-only sums) of the batched call and of the C = 1
    call on the HME fields; work summed over the batch."""
    import torch

    from dsv1_tpu_torch.ops import mc
    G, nb, W, H = enc.G, enc.nbh * enc.nbv, enc.w, enc.h
    im = imgs[0].view(C, G, -1)
    i = int(mv["nintra"].view(C, G - 1).sum(0).argmax()) + 1
    ref = im[:, i - 1].contiguous()
    gen = torch.Generator().manual_seed(seed)

    def fuzz(hi, lo=0):
        return torch.randint(lo, hi, (C, nb), generator=gen,
                             dtype=torch.int32).to(dev)

    fields = [tuple(mv[k].view(C, G - 1, -1)[:, i - 1]
                    for k in ("mode", "mvx", "mvy", "submask")),
              (fuzz(2), fuzz(4 * W, -4 * W), fuzz(4 * H, -4 * H), fuzz(16))]
    geo = (enc.layouts[0], enc.blk_w, enc.blk_h, enc.nbh, enc.nbv)
    err_plain = err_single = 0
    for f in fields:
        got = mc.predict_frame(ref, *geo, *f)
        err_plain = max(err_plain, max_abs_err(
            got, mc.predict_frame_plain(ref, *geo, *f)))
        err_single = max(err_single, max_abs_err(got, torch.stack([
            mc.predict_frame(ref[z], *geo, *(x[z] for x in f))
            for z in range(C)])))
    f = fields[0]
    kern = lambda: mc.predict_frame(ref, *geo, *f)  # noqa: E731
    one = lambda: mc.predict_frame(ref[0], *geo,  # noqa: E731
                                   *(x[0] for x in f))
    planes, _ = mc.frame_geometry(*geo[:3])
    work = [work_mc(planes, enc.nbh, enc.nbv, tuple(x[z] for x in f))
            for z in range(C)]
    ms, dev_ms = cuda_ms(kern, 50), device_ms(kern, 50)
    return {"kernel": "mc", "size": f"{W}x{H}", "C": C, "frame_index": i,
            "max_abs_err_plain": err_plain, "max_abs_err_single": err_single,
            "ms": ms, "ms_per_frame": ms / C, "device_ms": dev_ms,
            "device_ms_per_frame": dev_ms / C, "ms_c1": cuda_ms(one, 50),
            "device_ms_c1": device_ms(one, 50),
            "plain_ms": cuda_ms(lambda: mc.predict_frame_plain(ref, *geo,
                                                               *f), 2),
            "work": (sum(x[0] for x in work), sum(x[1] for x in work))}


def check_haar_batch(dev, C, hs, ws, is_p, seed):
    """`haar_fwd` on a batch: the pyramids of C planes (fwd_sbt's
    arguments for C random (hs, ws) planes, P or I) in one C call,
    against the plain version and against C single-plane calls. Times
    (CUDA events, device-only sums) of the batched call and of the C = 1
    call; work summed over the batch."""
    import torch

    from dsv1_tpu_torch.ops import sbt
    cases = [haar_case(dev, hs, ws, is_p, seed + z) for z in range(C)]
    cur = torch.stack([c[0] for c in cases])
    out = torch.stack([c[1] for c in cases])
    first, lvls = cases[0][2:]
    out_k, out_p, single = out.clone(), out.clone(), out.clone()
    sbt.haar_fwd_pyramid(cur, out_k, first, lvls)
    sbt._haar_fwd_pyramid_plain(cur, out_p, first, lvls)
    for z in range(C):
        sbt.haar_fwd_pyramid(cur[z], single[z], first, lvls)
    kern = lambda: sbt.haar_fwd_pyramid(cur, out_k, first, lvls)  # noqa
    one = lambda: sbt.haar_fwd_pyramid(cur[0], single[0],  # noqa: E731
                                       first, lvls)
    ms, dev_ms = cuda_ms(kern, 50), device_ms(kern, 50)
    nbytes, ops = work_haar(*cur.shape[1:])
    return {"kernel": "haar_fwd", "size": f"{ws}x{hs}",
            "plane": "P" if is_p else "I", "C": C,
            "max_abs_err_plain": max_abs_err(out_k, out_p),
            "max_abs_err_single": max_abs_err(out_k, single),
            "ms": ms, "ms_per_plane": ms / C, "device_ms": dev_ms,
            "device_ms_per_plane": dev_ms / C, "ms_c1": cuda_ms(one, 50),
            "device_ms_c1": device_ms(one, 50),
            "plain_ms": cuda_ms(lambda: sbt._haar_fwd_pyramid_plain(
                cur, out_p, first, lvls), 2),
            "work": (C * nbytes, C * ops)}


def run_metrics(fn, n: int) -> dict:
    """fn() encodes or decodes n frames: after a warm-up, frames/s of one
    run and, from one more run under torch.profiler, the device kernels
    and device-to-host copies per frame, the device busy share (the
    kernels' and copies' device time over the run's wall) and the host
    seconds of the encoder's spans, as tools/torch_profile.py reads
    them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tools.torch_profile import SPANS
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    busy_us, kernels, reads, spans = 0.0, 0, 0, {}
    for e in prof.key_averages():
        if e.key in SPANS:
            if e.device_type == DeviceType.CPU:
                spans[e.key] = e.cpu_time_total * 1e-6
            continue
        if e.device_type != DeviceType.CUDA:
            continue
        busy_us += e.self_device_time_total
        if not e.key.startswith(("Memcpy", "Memset")):
            kernels += e.count
        elif e.key.startswith("Memcpy DtoH"):
            reads += e.count
    if kernels == 0:
        raise AssertionError("the profiler saw no device kernel")
    return {"fps": n / wall, "wall_s": wall,
            "kernels_per_frame": kernels / n,
            "host_reads_per_frame": reads / n,
            "device_busy_share": busy_us * 1e-6 / pwall,
            "profiled_wall_s": pwall, "spans_s": spans}


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_shard_processes(clip: str, n: int, out: Path):
    """`run_distributed_shard` in n processes on this card (gloo on
    127.0.0.1, tools/torch_shard_worker.py), each waited for with its
    own timeout and killed past it: (exit codes, each rank's JSON)."""
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tools" / "torch_shard_worker.py"),
         f"127.0.0.1:{port}", str(n), str(r), str(out), "--clip", clip,
         "--device", "cuda"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(n)]
    ranks = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=SHARD_TIMEOUT_S)
            lines = o.strip().splitlines()
            ranks.append(json.loads(lines[-1]) if p.returncode == 0
                         and lines else {"stderr": e[-2000:]})
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], ranks


def phase_batches(dev, bound, smi, golden, clips):
    """Main path 5: several GOPs through each launch. First the batched
    `mc` (C = 4 at CIF, the P frames of one frame index of a chunk; C = 2
    at 1080p) and `haar_fwd` (C planes in one call) against their plain
    versions and against C single calls. Then, each against its golden
    with its launches predicted: `cif_batch` through encode_stream_gops
    at its default chunk (4 GOPs, then a padded tail), where every P
    call must carry 4 frames, with frames/s, kernels per encoded frame
    and the device busy share at the default and at gops_per_device=1
    (the same bytes); `cif_batch_cut` (stable_refresh 4, a cut in the
    second GOP: carried stability states and a frame index split into P
    and intra frames); `1080p_gopabr_batch` (-gopabr1 settings, 2 GOPs a
    chunk: bytes of its own, not `1080p_gopabr_cli`'s); then
    `cif_batch`'s clip through encode_stream_multihost with 3 shards in
    this process and through run_distributed_shard in 2 processes on
    this card, each muxed stream equal to `cif_batch`'s golden. Returns
    ({kernel: largest batch error}, the launches summed over the
    phase's paths)."""
    import torch

    import dsv1_tpu_torch as dt
    from dsv1_tpu_torch.kernels.build import LAUNCHES
    from dsv1_tpu_torch.utils.golden import API, decoded_bytes, encode_args
    from dsv1_tpu_torch.utils.stats import STATS

    t_phase = time.perf_counter()

    def since():
        return time.perf_counter() - t_phase

    checks = []
    enc, imgs, mv = chunk_motion(dev, clips[BATCH_CLIP][1], 4)
    checks.append(check_mc_batch(dev, enc, imgs, mv, 4, 31))
    enc, imgs, mv = chunk_motion(dev, clips["1080p"][1], 2)
    checks.append(check_mc_batch(dev, enc, imgs, mv, 2, 32))
    del imgs, mv
    for C, (hs, ws) in ((4, (288, 352)), (2, (1080, 1920))):
        for is_p in (True, False):
            checks.append(check_haar_batch(dev, C, hs, ws, is_p, 40))
    errs = {}
    for r in checks:
        r["bound_ms"], r["bound_by"] = bound(*r.pop("work"))
        emit({"phase": "batches", **r, "card": smi, "phase_s": since()})
        errs[r["kernel"]] = max(errs.get(r["kernel"], 0),
                                r["max_abs_err_plain"],
                                r["max_abs_err_single"])
    if any(errs.values()):
        raise AssertionError(f"a batched kernel disagrees: {errs}")
    torch.cuda.empty_cache()

    total = {}

    def run(path, fn, w, h, kernels=BASE_PATH):
        torch.cuda.synchronize()
        LAUNCHES.clear()
        STATS.clear()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = dict(LAUNCHES)
        check_launches(path, got, kernels)
        check_predicted(path, got, STATS, w, h)
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        return secs, got, dict(STATS), result

    for name in (BATCH_CLIP, CUT_CLIP, GOPABR_BATCH_CLIP):
        gold = golden[name]
        yuv, frames = clips[name]
        if sha(yuv) != gold["clip_sha256"]:
            raise AssertionError(f"{name}: input clip differs from the "
                                 "golden clip")
        meta, cfg, kw = encode_args(name)
        w, h, n = gold["width"], gold["height"], gold["frames"]

        def encode(**extra):
            return dt.encode_stream_gops(frames, meta, cfg, dev,
                                         **{**kw, **extra})

        t_enc, l_enc, st, stream = run(f"{name} encode", encode, w, h)
        t_dec, l_dec, _, dec = run(f"{name} decode", lambda: (
            dt.decode_stream_gops(stream, device=dev)[1]), w, h, DECODE_PATH)
        res = {"phase": "batches", "clip": name, "size": f"{w}x{h}",
               "frames": n, "encode": API[name],
               "stream_bytes": len(stream),
               "stream_sha256_ok": sha(stream) == gold["stream_sha256"],
               "decode_sha256_ok": sha(decoded_bytes(dec))
               == gold["decode_sha256"],
               "encode_fps": n / t_enc, "decode_fps": n / t_dec,
               "encode_launches": l_enc, "decode_launches": l_dec,
               "launches_as_predicted": True, "chunks": st["chunks"],
               "core_calls_p": st.get("core_calls_p", 0),
               "p_frames_per_call": st.get("core_p", 0)
               / max(st.get("core_calls_p", 0), 1),
               "core_calls_i": st.get("core_calls_i", 0),
               "stab_carried": st.get("stab_carried", 0),
               "overflow_redos": st.get("overflow_redos", 0)}
        if name == BATCH_CLIP:
            # 4 GOPs through every P launch; then the same encode at 4
            # and at 1 GOP a chunk, timed and profiled
            res["every_p_call_4_gops"] = st["core_p"] == 4 * st["core_calls_p"]
            streams_c1 = []

            def encode_c1():
                streams_c1.append(encode(gops_per_device=1))

            res.update(metrics_c4=run_metrics(encode, n),
                       metrics_c1=run_metrics(encode_c1, n),
                       metrics_decode=run_metrics(lambda: (
                           dt.decode_stream_gops(stream, device=dev)), n))
            res["c1_stream_equal_ok"] = all(x == stream for x in streams_c1)
        elif name == CUT_CLIP:
            res["stab_carried_ok"] = st.get("stab_carried", 0) > 0
            res["mixed_frame_index_ok"] = st["core_calls_i"] > st["chunks"]
        else:
            res["differs_from_gopabr_cli_ok"] = (
                gold["stream_sha256"] != golden[GOPABR_CLIP]["stream_sha256"])
        res.update(card=smi, phase_s=since())
        emit(res)
        bad = [k for k, v in res.items() if (k.endswith("_ok")
                                             or k.startswith("every_"))
               and not v]
        if bad:
            raise AssertionError(f"{name}: {bad} failed")

    gold = golden[BATCH_CLIP]
    meta, cfg, _kw = encode_args(BATCH_CLIP)
    frames = clips[BATCH_CLIP][1]
    t_mh, l_mh, st, stream = run("cif_shards encode_stream_multihost", (
        lambda: dt.encode_stream_multihost(frames, meta, cfg, n_shards=3,
                                           device=dev)),
        gold["width"], gold["height"])
    with tempfile.TemporaryDirectory() as td:
        out = Path(td) / "shards.dsv"
        t0 = time.perf_counter()
        codes, ranks = run_shard_processes(BATCH_CLIP, 2, out)
        t_proc = time.perf_counter() - t0
        procs_ok = codes == [0, 0] and out.exists() \
            and sha(out.read_bytes()) == gold["stream_sha256"]
    res = {"phase": "batches", "clip": "cif_shards",
           "multihost_3_shards_sha256_ok": sha(stream)
           == gold["stream_sha256"], "multihost_seconds": t_mh,
           "multihost_launches": l_mh, "launches_as_predicted": True,
           "chunks": st["chunks"], "two_processes_sha256_ok": procs_ok,
           "two_processes_exit_codes": codes, "ranks": ranks,
           "two_processes_seconds": t_proc, "card": smi,
           "phase_s": since()}
    emit(res)
    bad = [k for k, v in res.items() if k.endswith("_ok") and not v]
    if bad:
        raise AssertionError(f"cif_shards: {bad} failed")
    emit({"phase": "batches", "launches": total})
    return errs, total


MESH_ENTRIES = 2           # gop_mesh(["cuda:0"] * 2)
TILE_ENTRIES = 4           # tile_mesh(["cuda:0"] * 4)
LIMIT_GEOMETRY = (256, 192, 64, 6)   # w, h, block, pyramid levels


def panned_pair(w, h, sx, sy, seed):
    """Two 4:2:0 frames: a smooth textured scene, and the scene panned by
    (sx, sy) pixels (grey chroma)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h + abs(sy), 0:w + abs(sx)].astype(np.float64)
    scene = (128 + 60 * np.sin(x / 23 + 0.7 * np.sin(y / 31))
             + 40 * np.cos(y / 17 - x / 41) + rng.normal(0, 4, x.shape))
    scene = np.clip(scene, 0, 255).astype(np.uint8)
    grey = np.full((h // 2, w // 2), 128, np.uint8)
    return [(scene[oy:oy + h, ox:ox + w], grey, grey)
            for oy, ox in ((max(-sy, 0), max(-sx, 0)),
                           (max(sy, 0), max(sx, 0)))]


def check_limit_hme(dev, seed):
    """The level-0 search at the +-64 limit: a 64-pixel pan in both axes
    at 64x64 blocks and 6 levels, both ways round (B = 2). `hme_batch`
    on the card against the port on the CPU (plain versions, which
    follow the JAX package's XLA route there:
    tests/test_torch_effort.py) at effort 0 and 2; then kernel #3
    (`refine_base_cm`) and kernel #2 at level 0 (`refine_level`) against
    their plain versions on hme_batch's own arguments and on candidates
    at the +-64 limits (`edge_cands`), `refine_wide` on its own `pre`
    and on one at the edges of the 9-point search (`edge_pre`), and the
    coarse call. Returns the largest error per kernel and of hme_batch."""
    import numpy as np
    import torch

    import dsv1_tpu_torch as dt
    from dsv1_tpu_torch.models.encoder import make_prep, pyr_layouts
    from dsv1_tpu_torch.ops import hme_kernels as hk
    from dsv1_tpu_torch.ops.hme import hme_batch
    from dsv1_tpu_torch.utils.edges import edge_cands, edge_pre
    w, h, blk, levels = LIMIT_GEOMETRY
    nbh, nbv = -(-w // blk), -(-h // blk)
    pair = panned_pair(w, h, -64, -64, seed)
    planes = [torch.from_numpy(np.stack([f[c] for f in pair]))
              for c in range(3)]
    prep = make_prep(dt.SUBSAMP_420, w, h, levels)
    lays = pyr_layouts(dt.SUBSAMP_420, w, h, levels)
    rng = np.random.default_rng(seed)
    geo = (nbh, nbv, w, h, blk, blk)
    errs = {"hme_batch": 0}
    order = (torch.tensor([1, 0]), torch.tensor([0, 1]))

    def err(name, a, b):
        errs[name] = max(errs.get(name, 0), max_abs_err(a, b))

    for effort in (0, 2):
        out, calls = {}, []
        for d in (dev, torch.device("cpu")):
            imgs, _al = prep(tuple(p.to(d) for p in planes))
            src, ref = ([a.index_select(0, o.to(d)) for a in imgs]
                        for o in order)
            out[d.type] = hme_batch(src, ref, lays, blk, blk, nbh, nbv,
                                    dt.SUBSAMP_420, levels,
                                    calls if d.type == "cuda" else None,
                                    effort)
        for k, v in out["cuda"].items():
            err("hme_batch", v, out["cpu"][k].to(dev))
        args = dict(calls)
        err("hme_refine", hk.refine_coarse(*args["hme_coarse"]),
            hk.refine_coarse_plain(*args["hme_coarse"]))
        if effort == 0:
            ba = args["hme_base"]
            err("hme_base", hk.refine_base_cm(*ba), base_plain(ba))
            fb = (*ba[:3], *edge_cands(rng, dev, 2, *geo, 64), *ba[4:])
            err("hme_base", hk.refine_base(*fb), hk.refine_base_plain(*fb))
        else:
            la, wa = args["hme_level0"], args["hme_wide"]
            fl = (*la[:3], *edge_cands(rng, dev, 2, *geo, 64), *la[5:])
            for a in (la, fl):
                err("hme_refine_level0", hk.refine_level(*a),
                    hk.refine_level_plain(*a))
            for pre in (wa[7], edge_pre(rng, dev, 2, *geo)):
                a = (*wa[:7], pre, effort)
                err("hme_wide", hk.refine_wide(*a), hk.refine_wide_plain(*a))
    return errs


def check_tiles(dev, frames, smi, tile_devs):
    """`fwd_sbt_tiled`, `inv_sbt_tiled` and `encode_plane_tiled` over
    tile_mesh(tile_devs) (["cuda:0"] * 4) on 1080p luma planes (an I plane: the
    clip's first frame; a P plane: its difference to the next, centred)
    against the untiled port functions on the card, with each call's
    `haar_fwd` launches against `tiled_haar`'s prediction and the
    tiled and untiled calls' times (CUDA events). Returns the largest
    error."""
    import numpy as np
    import torch

    import dsv1_tpu_torch as dt
    from dsv1_tpu_torch.kernels.build import LAUNCHES
    from dsv1_tpu_torch.models.encoder import coef_geometry
    from dsv1_tpu_torch.ops import hzcc, sbt
    tm = dt.tile_mesh(tile_devs)
    y0, y1 = (np.asarray(f[0], np.int32) for f in frames[:2])
    H, W = y0.shape
    nbh, nbv = -(-W // 64), -(-H // 48)
    table = coef_geometry(dt.SUBSAMP_420, W, H, nbh, nbv)[2][0]
    stable = torch.from_numpy(np.random.default_rng(3).integers(
        0, 4, nbh * nbv).astype(np.uint8)).to(dev)
    worst = 0
    for is_p, a_np in ((False, y0 - 128), (True, (y1 - y0).clip(-128, 127))):
        a = torch.from_numpy(np.ascontiguousarray(a_np, np.int32)).to(dev)
        tiles = dt.split_tiles(a, tm)
        LAUNCHES.clear()
        got = dt.fwd_sbt_tiled(tiles, is_p, tm)
        torch.cuda.synchronize()
        fwd_launches = LAUNCHES["haar_fwd"]
        want_l = tiled_haar(W, H, len(tile_devs), 2 - is_p)
        if fwd_launches != want_l or LAUNCHES["haar_fwd"] == 0:
            raise AssertionError(f"tiled fwd_sbt launched haar_fwd "
                                 f"{fwd_launches} times, predicted {want_l}")
        want = sbt.fwd_sbt(a, is_p)
        e = {"fwd": max_abs_err(dt.join_tiles(got), want)}
        e["inv"] = max(max_abs_err(
            dt.join_tiles(dt.inv_sbt_tiled(got, q, is_p, True, tm)),
            sbt.inv_sbt(want, q, is_p, True)) for q in (137, 1024))
        qv, dc, rec = dt.encode_plane_tiled(tiles, 512, is_p, 0, stable,
                                            nbh, nbv, tm)
        qv_w, wb = hzcc.encode_plane_core(want, 512, is_p, 0, stable, table)
        e["plane"] = max(max_abs_err(qv, qv_w), max_abs_err(dc, want[0, 0]),
                         max_abs_err(dt.join_tiles(rec),
                                     sbt.inv_sbt(wb, 512, is_p, True)))
        emit({"phase": "mesh", "check": "tiles", "plane": f"{W}x{H} luma "
              f"{'P' if is_p else 'I'}",
              "tiles": [str(d) for d in tile_devs],
              "max_abs_err": e, "haar_fwd_launches_fwd": fwd_launches,
              "haar_fwd_predicted": want_l, "haar_on_kernel": True,
              "fwd_tiled_ms": cuda_ms(lambda: dt.fwd_sbt_tiled(
                  tiles, is_p, tm), 5),
              "fwd_ms": cuda_ms(lambda: sbt.fwd_sbt(a, is_p), 5),
              "inv_tiled_ms": cuda_ms(lambda: dt.inv_sbt_tiled(
                  got, 512, is_p, True, tm), 5),
              "inv_ms": cuda_ms(lambda: sbt.inv_sbt(want, 512, is_p,
                                                    True), 5),
              "card": smi})
        worst = max(worst, *e.values())
    return worst


def phase_mesh(dev, smi, golden, clips, cards=None):
    """Phase 10: the batched decode, GOP meshes, column tiles and the
    gop x tile encode, on mesh entries that share the one card (so only
    the split, the carried state and the bytes are checked here, not
    scaling). Step by step: `check_limit_hme`; `cif_batch`'s stream
    decoded at the JAX rule's 4 chains a launch, against its golden
    decode, with decode frames/s and `mc` launches and P pictures per
    decoded frame; over gop_mesh(["cuda:0"] * 2) `cif_batch` encoded and
    decoded, the `1080p` CRF clip and `1080p_gopabr_batch`'s clip at
    -gopabr1's settings at 1 GOP a device (a chunk of 2 GOPs, the bytes
    of 2 GOPs a chunk on one device, as in the JAX package), each
    against its golden; `check_tiles`; gop_tile_mesh(1, 4) on the
    `1080p` clip and (2, 2) on `cif`, against their goldens. Launches
    equal predict_launches on every path. The mesh entries are the
    `cards` in turn (one card, `dev`, by default; every visible card in
    tools/torch_mesh_cards.py). Returns (the largest error per kernel,
    the launches summed over the paths)."""
    import torch

    import dsv1_tpu_torch as dt
    from dsv1_tpu_torch.kernels.build import LAUNCHES
    from dsv1_tpu_torch.utils.golden import decoded_bytes, encode_args
    from dsv1_tpu_torch.utils.stats import STATS

    t_phase = time.perf_counter()
    cards = cards or [dev]

    def since():
        return time.perf_counter() - t_phase

    def entries(k):
        return [cards[i % len(cards)] for i in range(k)]

    errs = check_limit_hme(dev, 21)
    emit({"phase": "mesh", "check": "level0_limit",
          "geometry": "x".join(map(str, LIMIT_GEOMETRY)),
          "max_abs_err": errs, "card": smi, "phase_s": since()})
    if any(errs.values()):
        raise AssertionError(f"the search at the +-64 limit disagrees: "
                             f"{errs}")
    total = {}

    def run(path, fn, w, h, kernels=BASE_PATH, tiles=1):
        torch.cuda.synchronize()
        LAUNCHES.clear()
        STATS.clear()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = dict(LAUNCHES)
        check_launches(path, got, kernels)
        check_predicted(path, got, STATS, w, h, tiles)
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        return secs, got, dict(STATS), result

    def ok(name, gold, stream=None, dec=None):
        res = {}
        if stream is not None:
            res["stream_sha256_ok"] = sha(stream) == gold["stream_sha256"]
        if dec is not None:
            res["decode_sha256_ok"] = (sha(decoded_bytes(dec))
                                       == gold["decode_sha256"])
        bad = [k for k, v in res.items() if not v]
        if bad:
            raise AssertionError(f"{name}: {bad} differ from the golden")
        return res

    # the batched decode at the JAX rule
    gold = golden[BATCH_CLIP]
    meta, cfg, kw = encode_args(BATCH_CLIP)
    frames = clips[BATCH_CLIP][1]
    w, h, n = gold["width"], gold["height"], gold["frames"]
    stream = dt.encode_stream_gops(frames, meta, cfg, dev, **kw)
    run("cif_batch decode (warm-up)", lambda: dt.decode_stream_gops(
        stream, device=dev), w, h, DECODE_PATH)
    t_dec, l_dec, st, (_m, dec) = run("cif_batch decode", lambda: (
        dt.decode_stream_gops(stream, device=dev)), w, h, DECODE_PATH)
    emit({"phase": "mesh", "clip": BATCH_CLIP, "path": "batched decode",
          **ok(BATCH_CLIP, gold, dec=dec), "decode_fps": n / t_dec,
          "mc_launches": l_dec.get("mc", 0),
          "mc_launches_per_decoded_frame": l_dec.get("mc", 0) / n,
          "p_pictures_per_mc_launch": st["decode_p"]
          / max(st["decode_p_calls"], 1),
          "chains_per_launch": 4, "launches_as_predicted": True,
          "card": smi, "phase_s": since()})

    # GOP meshes on the one card
    gm = dt.gop_mesh(entries(MESH_ENTRIES))
    for name, extra in ((BATCH_CLIP, {}), ("1080p", {}),
                        (GOPABR_BATCH_CLIP, {"gops_per_device": 1})):
        gold = golden[name]
        meta, cfg, kw = encode_args(name)
        kw = {**kw, **extra}
        frames = clips[name][1]
        w, h, n = gold["width"], gold["height"], gold["frames"]
        t_enc, l_enc, st, stream = run(f"{name} mesh encode", lambda: (
            dt.encode_stream_gops(frames, meta, cfg, mesh=gm, **kw)), w, h)
        res = {"phase": "mesh", "clip": name,
               "path": f"gop_mesh {[str(d) for d in gm.devices]}",
               **ok(name, gold, stream), "encode_fps": n / t_enc,
               "encode_launches": l_enc, "chunks": st["chunks"],
               "stab_carried": st.get("stab_carried", 0),
               "launches_as_predicted": True}
        if name == BATCH_CLIP:
            t_dec, l_dec, _st, (_m, dec) = run(
                f"{name} mesh decode", lambda: dt.decode_stream_gops(
                    stream, mesh=gm), w, h, DECODE_PATH)
            res.update(ok(name, gold, dec=dec), decode_fps=n / t_dec,
                       decode_launches=l_dec)
        emit({**res, "card": smi, "phase_s": since()})

    tile_err = check_tiles(dev, clips["1080p"][1], smi,
                           entries(TILE_ENTRIES))
    if tile_err:
        raise AssertionError(f"the tiled transforms disagree: {tile_err}")

    for name, shape in (("1080p", (1, TILE_ENTRIES)), ("cif", (2, 2))):
        gold = golden[name]
        meta, cfg, kw = encode_args(name)
        frames = clips[name][1]
        w, h, n = gold["width"], gold["height"], gold["frames"]
        mesh = dt.gop_tile_mesh(*shape, entries(shape[0] * shape[1]))
        t_enc, l_enc, st, stream = run(f"{name} gop x tile encode", lambda: (
            dt.encode_stream_gops(frames, meta, cfg, mesh=mesh, **kw)), w, h,
            TILE_PATH, tiles=shape[1])
        emit({"phase": "mesh", "clip": name,
              "path": f"gop_tile_mesh{shape}",
              "devices": [str(d) for d in mesh.devices.reshape(-1)],
              **ok(name, gold, stream),
              "encode_fps": n / t_enc, "encode_launches": l_enc,
              "chunks": st["chunks"], "launches_as_predicted": True,
              "card": smi, "phase_s": since()})
    emit({"phase": "mesh", "launches": total, "seconds": since()})
    return {**errs, "haar_fwd": tile_err}, total


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    # fail before printing anything when the port is not beside this file
    sys.path.insert(0, str(ROOT))
    try:
        import dsv1_tpu_torch  # noqa: F401
    except ModuleNotFoundError as e:
        if e.name != "dsv1_tpu_torch":
            raise
        raise SystemExit(f"chip_smoke: dsv1_tpu_torch is not beside {ROOT}: "
                         "run this script from a checkout of the repository")
    from dsv1_tpu_torch.utils import golden as g

    smi, clock_hz = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    golden = g.load()
    clips = {name: g.clip_frames(name) for name in g.CLIPS}
    rows = phase_kernels(dev, Bound(clock_hz), clips)
    mc_formats = phase_edges(dev)
    for r in rows:
        if r["name"] == "mc":
            r["max_abs_err"] = max(r["max_abs_err"], *mc_formats.values())
    if max(mc_formats.values()) != 0:
        raise AssertionError("kernel mc disagrees with its plain version "
                             "on 4:2:2 or 4:1:1 chroma")
    slice_l = phase_slice(dev, smi, golden, clips)
    cli_l = phase_cli(dev, smi, golden, clips)
    seq_l = phase_sequential(dev, smi, golden, clips)
    effort_r, effort_l = phase_effort(dev, Bound(clock_hz), smi, golden,
                                      clips)
    rows += effort_r
    batch_err, batch_l = phase_batches(dev, Bound(clock_hz), smi, golden,
                                       clips)
    mesh_err, mesh_l = phase_mesh(dev, smi, golden, clips)
    for r in rows:
        for errs in (batch_err, mesh_err):
            if r["name"] in errs:
                r["max_abs_err"] = max(r["max_abs_err"], errs[r["name"]])
    # every main path's launches; 4k_cli's level 0 is #4's work (the JAX
    # package's banded kernel), counted on its own row
    banded = cli_l["4k_cli"]["hme_base"]
    path_launches = {k: slice_l.get(k, 0) + seq_l.get(k, 0)
                     + sum(c.get(k, 0) for c in cli_l.values())
                     + effort_l.get(k, 0) + batch_l.get(k, 0)
                     + mesh_l.get(k, 0) for k in KERNELS}
    path_launches["hme_base"] -= banded
    path_launches["hme_base_banded"] = banded
    for r in rows:
        r["launches"] = path_launches[r["name"]]
    emit({"kernels": [{k: r[k] for k in ROW_KEYS} for r in rows]})
    loaded = sorted(m for m in sys.modules
                    if m.startswith(("jax", "dsv1_tpu"))
                    and m.split(".")[0] != "dsv1_tpu_torch")
    if loaded:
        raise AssertionError(f"the port's run loaded {loaded}")
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
