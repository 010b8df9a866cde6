"""Times the port's kernels' units of work on the GPU.

    python3 tools/torch_kernel_times.py [--root DIR]
        [--only haar,mc,hme,recon] [--e2e N] [--out FILE]

The units of work the encoder hands to the Haar, MC and HME kernels, at
the main path's shapes, on random coefficients and on golden clips'
frames and motion fields (for MC the P frame with the most intra blocks
of the first GOP, as chip_smoke.py picks it):

- `sbt.fwd_sbt` of one 1080p luma P plane, one 1080p luma I plane (its
  B4T level included) and one 3840x2160 luma P plane;
- the MC prediction of the three planes of one 1080p and one 3840x2160
  P frame: `bmc.compensate_frame` where the port has it, else
  `bmc.compensate_plane` for c = 0, 1, 2 (so one script times a tree
  from before the frame-wide kernel too);
- `hme.hme_batch` of the first GOP (11 P-frame pairs, every pyramid
  level) of the 1080p and the 3840x2160 clip, as `GopEncoder.motion`
  calls it, and the HME kernels' wrappers on the arguments it passes
  them (the coarse levels, one `refine_coarse` call or, on a tree from
  before it, one `refine_level` call per level; level 0);
- where the port has the wider level-0 search (effort 1..3),
  `hme.hme_batch` of those GOPs and of the CIF clip's (16x16 blocks) at
  effort 3 and its level-0 wrappers: kernel #2 at level 0
  (`refine_level`) and `refine_wide` at efforts 1, 2 and 3, on the GOP
  and on its first pair alone (B = 1).

- `recon`: the recon chain's frame step on the 1080p, the 3840x2160 and
  the CIF clip's second frame: the encode core (`make_encode_core_traced`'s
  function) on it as a P frame (the HME field of the first GOP, the
  first frame as its reference) and as an I frame, and its units: the
  prologue (`bmc.residual_in`, where the port has it), the intra B4T
  level (`sbt.b4t_fwd`, else `sbt._b4t_fwd_2d`), `hzcc.encode_plane_core`
  and `hzcc.dequant_plane_grid` on the luma plane's coefficients, and the
  luma recon (`sbt.inv_sbt_recon`, else `inv_sbt`, `coefs_to_plane` and
  `bmc.add_residual`): on a tree from before the recon kernels, the
  eager chain they replace.

For each: the CUDA-event mean per call over a loop of calls (the
wrappers' host work included), the device time per call summed from
torch.profiler's kernel events and as the union of their intervals
(the device time where kernels overlap), of the sum the time of the
case's own
hand-written kernels (`haar_`, `mc_` or `hme_` in the name; for `recon`
every hand-written kernel's), and the kernels launched and
host-to-device copies made per call; for `encode_plane_core` and the
luma recon also the device time per call with the host out of the way
(`graph_ms`: 20 calls in a CUDA graph, replayed 10 times).
`--e2e N` also times N encodes (`encode_stream_gops`, CRF) and N
decodes of the 1080p golden clip (or of `--e2e-clip`, an
encode_stream_gops golden clip with its own arguments, such as
`cif_batch`) after a warm-up, each to its last device sync, on the host
clock, with the MC launches of a decode.
`--root` imports the port from another checkout (for example an
unpacked parent commit), so two trees are timed by one script in one
call. Needs a CUDA device.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# this tree's chip_smoke (stdlib only at import), whatever --root times
sys.path.insert(0, str(ROOT))
from chip_smoke import union_us  # noqa: E402


def event_ms(fn, reps: int) -> float:
    """Mean CUDA-event time of fn() over reps calls, after a warm-up."""
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


# the names of the port's hand-written kernels hold one of these
OWN_KERNELS = ("haar_", "mc_", "hme_", "hzcc_", "inv_", "b4t_",
               "residual_in")


def device_ms(fn, reps: int, own="dsv1"):
    """(device ms per call, kernels per call, host-to-device copies per
    call, device ms per call of the kernels whose names hold `own`, a
    string or a tuple of them, the union of the call's kernel intervals)
    from torch.profiler's device events over reps calls (memcpy and
    memset events left out of all but the copies). The first and fourth
    sum kernel durations; a kernel chained by programmatic dependent
    launch starts before the one it waits on ends, and its duration
    counts that wait, so where kernels overlap the union is the device
    time."""
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
    us, n, h2d, own_us = 0.0, 0, 0, 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        if e.key.startswith("Memcpy HtoD"):
            h2d += e.count
        if e.key.startswith(("Memcpy", "Memset")):
            continue
        us += e.self_device_time_total
        n += e.count
        if any(o in e.key for o in ((own,) if isinstance(own, str)
                                    else own)):
            own_us += e.self_device_time_total
    union = union_us((e.time_range.start, e.time_range.end)
                     for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and not e.name.startswith(("Memcpy", "Memset"))) * 1e-3
    return (us * 1e-3 / reps, n / reps, h2d / reps, own_us * 1e-3 / reps,
            union / reps)


def graph_ms(fn, calls: int = 20, reps: int = 10) -> float:
    """Device time per call of fn with the host out of the way: `calls`
    calls captured in one CUDA graph, replayed `reps` times between CUDA
    events."""
    import torch
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        g.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (calls * reps)


def timed(name, fn, reps, own, graph=False):
    """A row: CUDA-event ms a call, device_ms' numbers and, with graph,
    graph_ms (for calls that never wait on the host)."""
    ev = event_ms(fn, reps)
    dev, kern, h2d, own_ms, union = device_ms(fn, reps, own)
    tag = f"{own}*" if isinstance(own, str) else "own_kernels"
    row = {"name": name, "ms": ev, "device_ms": dev,
           "device_union_ms": union, "kernels_per_call": kern,
           "h2d_copies_per_call": h2d, f"device_ms_of_{tag}": own_ms}
    if graph:
        row["graph_ms"] = graph_ms(fn)
    return row


def haar_cases(dev):
    import numpy as np
    import torch

    from dsv1_tpu_torch.ops import sbt
    out = []
    for tag, (h, w), is_p in (("1080p luma P", (1080, 1920), True),
                              ("1080p luma I", (1080, 1920), False),
                              ("4K luma P", (2160, 3840), True)):
        a = np.random.default_rng(h + is_p).integers(-255, 256, (h, w))
        coefs = torch.from_numpy(a.astype(np.int32)).to(dev)
        out.append(timed(f"fwd_sbt {tag}",
                         lambda c=coefs, p=is_p: sbt.fwd_sbt(c, p), 50,
                         "haar_"))
    return out


def mc_case(dev, clip):
    from dsv1_tpu_torch.ops import bmc

    enc, imgs, mv = gop_motion(dev, clip)
    k = int(mv["nintra"].argmax())
    img, lay = imgs[0][k], enc.layouts[0]
    fields = tuple(mv[key][k] for key in ("mode", "mvx", "mvy", "submask"))
    geo = (enc.blk_w, enc.blk_h, enc.nbh, enc.nbv)
    if hasattr(bmc, "compensate_frame"):
        def fn():
            return bmc.compensate_frame(img, lay, *geo, *fields)
        unit = "compensate_frame"
    else:
        def fn():
            return [bmc.compensate_plane(img, lay, c, *geo, *fields)
                    for c in range(3)]
        unit = "compensate_plane x3"
    r = timed(f"MC {clip} frame ({unit})", fn, 50, "mc_")
    r["intra_blocks"] = int(mv["nintra"][k])
    return r


def gop_images(dev, clip):
    """(GopEncoder, pyramid images) of a clip's first GOP, as
    `GopEncoder.motion` builds them."""
    import numpy as np
    import torch

    import dsv1_tpu_torch as dt
    from dsv1_tpu_torch.ops import frame as fr
    from dsv1_tpu_torch.parallel.gop import build_gop_encoder
    from dsv1_tpu_torch.utils.golden import GOP, QUALITY_PCT, clip_frames

    _yuv, frames = clip_frames(clip)
    h, w = frames[0][0].shape
    enc = build_gop_encoder(dt.SUBSAMP_420, w, h, GOP,
                            dt.quality_percent(QUALITY_PCT), True, 4, 50,
                            GOP - 1, 0, str(dev))
    packed = torch.from_numpy(np.stack([
        np.concatenate([np.asarray(p, np.uint8).ravel() for p in f])
        for f in frames[:GOP]])).to(dev)
    imgs, _al = enc.prep(fr.split_packed_planes(packed, enc.subsamp, w, h))
    return enc, imgs


def hme_calls(enc, imgs, effort=0):
    """`hme.hme_batch` on a GOP's images (at `effort`): (its function,
    the HME kernels' calls it made)."""
    from dsv1_tpu_torch.ops import hme
    kw = {"effort": effort} if effort else {}

    def fn(calls=None):
        return hme.hme_batch([a[1:] for a in imgs], [a[:-1] for a in imgs],
                             enc.layouts, enc.blk_w, enc.blk_h, enc.nbh,
                             enc.nbv, enc.subsamp, enc.levels, calls, **kw)
    calls = []
    fn(calls)
    return fn, calls


def hme_cases(dev, clip):
    """`hme.hme_batch` of a clip's first GOP (its G - 1 P-frame pairs),
    with the arguments `GopEncoder.motion` passes, and the HME kernels'
    wrappers on the arguments it passes them: the coarse levels
    (`refine_coarse` where the port has it, else one `refine_level`
    call per level) and level 0."""
    from dsv1_tpu_torch.ops import hme_kernels as hk

    enc, imgs = gop_images(dev, clip)
    fn, calls = hme_calls(enc, imgs)
    (bargs,) = [a for name, a in calls if name == "hme_base"]
    # level 0 takes the candidates as one tensor where the port has
    # refine_base_cm, as cmx and cmy before it
    base = getattr(hk, "refine_base_cm", hk.refine_base)
    if hasattr(hk, "refine_coarse"):
        (cargs,) = [a for name, a in calls if name == "hme_coarse"]

        def coarse():
            return hk.refine_coarse(*cargs)
        unit = "refine_coarse"
    else:
        largs = [a for name, a in calls if name == "hme_refine"]

        def coarse():
            return [hk.refine_level(*a) for a in largs]
        unit = f"refine_level x{len(largs)}"
    return [timed(f"hme_batch {clip} GOP ({len(imgs[0]) - 1} pairs, levels "
                  f"{enc.levels}..0)", fn, 20, "hme_"),
            timed(f"{unit} {clip} GOP (levels {enc.levels}..1)", coarse, 20,
                  "hme_"),
            timed(f"{base.__name__} {clip} GOP ({enc.blk_w}x{enc.blk_h})",
                  lambda: base(*bargs), 20, "hme_")]


def hme_effort_cases(dev, clip, effort=3):
    """The wider level-0 search of a clip's first GOP where the port has
    it (`hme_kernels.refine_wide`): `hme.hme_batch` at `effort`, and the
    wrappers of its level 0 on the arguments it passes them: kernel #2
    at level 0 (`refine_level`) and `refine_wide` at efforts 1..3, also
    on the first pair alone (B = 1)."""
    from dsv1_tpu_torch.ops import hme_kernels as hk
    if not hasattr(hk, "refine_wide"):
        return []
    enc, imgs = gop_images(dev, clip)
    fn, calls = hme_calls(enc, imgs, effort)
    (largs,) = [a for name, a in calls if name == "hme_level0"]
    (wargs,) = [a for name, a in calls if name == "hme_wide"]
    rows = [timed(f"hme_batch effort {effort} {clip} GOP "
                  f"({len(imgs[0]) - 1} pairs)", fn, 20, "hme_"),
            timed(f"refine_level level 0 {clip} GOP ({enc.blk_w}x"
                  f"{enc.blk_h})", lambda: hk.refine_level(*largs), 20,
                  "hme_")]
    one = (wargs[0][:1], wargs[1][:1], *wargs[2:7],
           tuple(t[:1] for t in wargs[7]))
    for e in (1, 2, 3):
        a = (*wargs[:-1], e)
        rows.append(timed(f"refine_wide effort {e} {clip} GOP", lambda a=a:
                          hk.refine_wide(*a), 20, "hme_"))
        rows.append(timed(f"refine_wide effort {e} {clip} pair 0 (B = 1)",
                          lambda a=(*one, e): hk.refine_wide(*a), 20, "hme_"))
    return rows


def recon_cases(dev, clip):
    """The recon chain's frame step on a clip's second frame (see the
    module docstring), on whichever functions the port has."""
    import torch

    from dsv1_tpu_torch.models.encoder import (build_encode_core,
                                               coef_geometry)
    from dsv1_tpu_torch.ops import bmc, frame as fr, hzcc, sbt

    enc, imgs, mv = gop_motion(dev, clip)
    w, h = enc.w, enc.h
    core = build_encode_core(enc.subsamp, w, h, True)
    stable = torch.zeros(enc.nbh * enc.nbv, dtype=torch.uint8, device=dev)
    fields = tuple(mv[k][0] for k in ("mode", "mvx", "mvy", "submask"))
    img, ref = imgs[0][1], imgs[0][0]
    q = enc.quant
    rows = [timed(f"encode core {clip} P frame", lambda: core(
                img, ref, True, q, stable, *fields), 20, OWN_KERNELS),
            timed(f"encode core {clip} I frame", lambda: core(
                img, None, False, q, stable, None, None, None, None), 20,
                OWN_KERNELS)]
    layout, dims, tables = coef_geometry(enc.subsamp, w, h, enc.nbh,
                                         enc.nbv)
    preds = bmc.compensate_frame(ref, layout, enc.blk_w, enc.blk_h, enc.nbh,
                                 enc.nbv, *fields)
    luma = fr.plane_view(img, layout, 0)
    src = luma.to(torch.int32) - 128
    if hasattr(bmc, "residual_in"):
        rows.append(timed(f"residual_in {clip} P frame", lambda: (
            bmc.residual_in(img, layout, dims, preds)), 50, OWN_KERNELS))
    b4t = getattr(sbt, "b4t_fwd", sbt._b4t_fwd_2d)
    rows.append(timed(f"{b4t.__name__} {clip} luma", lambda: b4t(src), 50,
                      OWN_KERNELS))
    res = bmc.sub_residual(luma, preds[0]).to(torch.int32) - 128
    coefs = sbt.fwd_sbt(res, True)
    qv, wb = hzcc.encode_plane_core(coefs, q, True, 0, stable, tables[0])
    rows.append(timed(f"encode_plane_core {clip} luma P", lambda: (
        hzcc.encode_plane_core(coefs, q, True, 0, stable, tables[0])), 50,
        OWN_KERNELS, True))
    rows.append(timed(f"dequant_plane_grid {clip} luma P", lambda: (
        hzcc.dequant_plane_grid(wb, 5, q, True, 0, stable, tables[0])), 50,
        OWN_KERNELS))
    if hasattr(sbt, "inv_sbt_recon"):
        out = torch.zeros_like(img)

        def recon():
            sbt.inv_sbt_recon(wb, q, True, True, out, layout, 0, preds[0])
        unit = "inv_sbt_recon"
    else:
        def recon():
            return bmc.add_residual(preds[0], sbt.coefs_to_plane(
                sbt.inv_sbt(wb, q, True, True)))
        unit = "inv_sbt + coefs_to_plane + add_residual"
    rows.append(timed(f"{unit} {clip} luma P", recon, 50, OWN_KERNELS,
                      True))
    return rows


def gop_motion(dev, clip):
    """(GopEncoder, images, motion) of a clip's first GOP."""
    import numpy as np
    import torch

    import dsv1_tpu_torch as dt
    from dsv1_tpu_torch.parallel.gop import build_gop_encoder
    from dsv1_tpu_torch.utils.golden import GOP, QUALITY_PCT, clip_frames

    _yuv, frames = clip_frames(clip)
    h, w = frames[0][0].shape
    enc = build_gop_encoder(dt.SUBSAMP_420, w, h, GOP,
                            dt.quality_percent(QUALITY_PCT), True, 4, 50,
                            GOP - 1, 0, str(dev))
    packed = torch.from_numpy(np.stack([
        np.concatenate([np.asarray(p, np.uint8).ravel() for p in f])
        for f in frames[:GOP]])).to(dev)
    imgs, _al, mv, _hr = enc.motion(packed)
    return enc, imgs, mv


def e2e_case(dev, reps: int, clip: str = "1080p"):
    """Host seconds of each of reps encodes and decodes of a golden clip
    (`encode_stream_gops` with the clip's arguments: 24 frames, gop 12,
    CRF for `1080p`), after one warm-up of each, and the MC launches of
    one decode."""
    import torch

    import dsv1_tpu_torch as dt
    from dsv1_tpu_torch.kernels.build import LAUNCHES
    from dsv1_tpu_torch.utils import golden

    _yuv, frames = golden.clip_frames(clip)
    h, w = frames[0][0].shape
    if clip in getattr(golden, "API", {}):
        meta, cfg, kw = golden.encode_args(clip)
    else:
        meta, kw = dt.Metadata(w, h, dt.SUBSAMP_420), {}
        cfg = dt.EncoderConfig(quality=dt.quality_percent(
            golden.QUALITY_PCT), gop=golden.GOP,
            stable_refresh=golden.GOP - 1)
    stream = dt.encode_stream_gops(frames, meta, cfg, dev, **kw)
    LAUNCHES.clear()
    dt.decode_stream_gops(stream, device=dev)
    torch.cuda.synchronize()
    mc = LAUNCHES["mc"]
    enc, dec = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dt.encode_stream_gops(frames, meta, cfg, dev, **kw)
        torch.cuda.synchronize()
        enc.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        dt.decode_stream_gops(stream, device=dev)
        torch.cuda.synchronize()
        dec.append(time.perf_counter() - t0)
    return {"name": f"{clip} encode/decode, {len(frames)} frames",
            "encode_s": enc, "decode_s": dec, "decode_mc_launches": mc}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(ROOT),
                    help="checkout whose dsv1_tpu_torch is timed")
    ap.add_argument("--out", default=None, help="also write JSON here")
    ap.add_argument("--only", default="haar,mc,hme,recon",
                    help="comma-separated cases to time (haar, mc, hme, "
                         "recon; none for --e2e alone)")
    ap.add_argument("--e2e", type=int, default=0, metavar="N",
                    help="also time N encodes and decodes of a clip")
    ap.add_argument("--e2e-clip", default="1080p",
                    help="the golden clip --e2e times (default 1080p)")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_times: needs a CUDA device")
    import dsv1_tpu_torch
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    only = args.only.split(",")
    rows = haar_cases(dev) if "haar" in only else []
    if "mc" in only:
        rows += [mc_case(dev, "1080p"), mc_case(dev, "4k_cli")]
    if "hme" in only:
        rows += hme_cases(dev, "1080p") + hme_cases(dev, "4k_cli")
        rows += (hme_effort_cases(dev, "1080p")
                 + hme_effort_cases(dev, "4k_cli")
                 + hme_effort_cases(dev, "cif"))
    if "recon" in only:
        rows += (recon_cases(dev, "1080p") + recon_cases(dev, "4k_cli")
                 + recon_cases(dev, "cif"))
    if args.e2e:
        rows.append(e2e_case(dev, args.e2e, args.e2e_clip))
    res = {"root": str(Path(dsv1_tpu_torch.__file__).parent.parent),
           "card": card, "seconds": time.perf_counter() - t0, "rows": rows}
    print(json.dumps(res, indent=1))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
