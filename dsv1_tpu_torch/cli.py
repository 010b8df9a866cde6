"""dsv1_tpu_torch command-line driver: the JAX package's CLI
(dsv1_tpu/cli.py) on the port.

    python -m dsv1_tpu_torch.cli e -inp_in.yuv -out_out.dsv -w3840 -h2160
    python -m dsv1_tpu_torch.cli d -inp_out.dsv -out_dec.yuv [-out420p1]

Same interface as the reference CLI (dsv_main.c:94-150): `e|d` mode with
-prefixvalue options and the same parameter tables as the JAX CLI; ABR
default rate control with the 0=ABR/1=CRF mapping, auto bitrate
estimation, the 3/2 ABR quality pre-boost and stabref auto =
clamp(gop-1, 1, 14). Encode routes as the JAX CLI does: the GOP-parallel
path (per-frame ABR or CRF, gop 0 under CRF) with frames read from disk
GOP by GOP, or the sequential `Encoder` frame by frame for -gopar0,
gop > 4096 and ABR at gop 0. Decode streams chain by chain, or runs the
sequential `Decoder` with -drawinfo. -gopabr1 picks GOP-granular ABR on
the GOP-parallel path; -effort1..3 widens the level-0 motion search on
every encode path.
`main(argv, device)` runs on the card unless the caller passes
device="cpu". File I/O runs under `torch.profiler.record_function`
spans: `cli.read` each input frame read by the encode, `cli.write` the
encode's output file and each frame the decode writes.
"""

import contextlib
import sys
from dataclasses import dataclass
from typing import Callable, Optional

from torch.profiler import record_function

from . import constants as C
from .models.decoder import Decoder
from .models.encoder import Encoder, EncoderConfig
from .models.metadata import Metadata
from .parallel import encode_stream_gops, iter_decode_gops
from .utils.bitrate import estimate_bitrate
from .utils.chroma import conv422to420, conv444to422
from .utils.yuv import read_frame, write_frame

HEADER = ("DSV1 codec driver (dsv1_tpu_torch: PyTorch/CUDA, "
          "reference-compatible)\n")

AUTO_BITRATE = 0
INP_FMTS = {0: C.SUBSAMP_444, 1: C.SUBSAMP_422, 2: C.SUBSAMP_420,
            3: C.SUBSAMP_411}


def pct_to_qual(v):
    return C.MAX_QUALITY * v // 100


@dataclass
class Param:
    prefix: str
    value: int
    vmin: int
    vmax: int
    convert: Optional[Callable[[int], int]]
    desc: str


def enc_params():
    M = 2**31 - 1
    return [
        Param("qp", pct_to_qual(85), 0, 100, pct_to_qual,
              "quality percent. 85 = default"),
        Param("w", 352, 16, 1 << 24, None, "width of input video"),
        Param("h", 288, 16, 1 << 24, None, "height of input video"),
        Param("gop", 12, 0, M, None,
              "Group Of Pictures length. 0 = intra only, 12 = default"),
        Param("fmt", C.SUBSAMP_420, 0, 3,
              lambda v: INP_FMTS.get(v, C.SUBSAMP_420),
              "chroma subsampling: 0=444 1=422 2=420 3=411. 2 = default"),
        Param("nfr", -1, -1, M, None, "number of frames (-1 = all)"),
        Param("sfr", 0, 0, M, None, "start frame number"),
        Param("fps_num", 30, 1, 1 << 24, None, "fps numerator"),
        Param("fps_den", 1, 1, 1 << 24, None, "fps denominator"),
        Param("aspect_num", 1, 1, 1 << 24, None, "aspect numerator"),
        Param("aspect_den", 1, 1, 1 << 24, None, "aspect denominator"),
        Param("ipct", 50, 0, 100, None,
              "intra block % threshold for I-frame promotion"),
        Param("pyrlevels", 0, 0, C.MAX_PYRAMID_LEVELS, None,
              "HME pyramid levels (0 = auto)"),
        Param("rc_mode", C.RATE_CONTROL_ABR, 0, 1,
              lambda v: C.RATE_CONTROL_CRF if v == 1 else C.RATE_CONTROL_ABR,
              "rate control: 0 = ABR, 1 = CRF. 0 = default"),
        Param("rc_hmnudge", 1, 0, 1, None, "high-motion RC nudge"),
        Param("kbps", AUTO_BITRATE, AUTO_BITRATE, M, lambda v: v * 1024,
              "ABR bitrate kbps (0 = auto-estimate)"),
        Param("maxqstep", C.MAX_QUALITY * 1 // 200, 1, C.MAX_QUALITY, None,
              "max ABR quality step"),
        Param("minqp", pct_to_qual(1), 0, 100, pct_to_qual, "min quality %"),
        Param("maxqp", pct_to_qual(100), 0, 100, pct_to_qual,
              "max quality %"),
        Param("iminqp", pct_to_qual(5), 0, 100, pct_to_qual,
              "min I-frame quality %"),
        Param("stabref", 0, 0, M, None,
              "stability refresh period (0 = auto)"),
        Param("scd", 1, 0, 1, None, "scene change detection"),
        Param("schdelta", 4, 0, 256, None, "scene change luma delta"),
        Param("gopar", 1, 0, 1, None,
              "GOP-parallel device encode (0 = the sequential encoder). "
              "1 = default"),
        Param("effort", 0, 0, 3, None,
              "motion search effort beyond the reference (exhaustive "
              "+-2*effort full-pel window). 0 = reference parity"),
        Param("gopabr", 0, 0, 1, None,
              "GOP-granular ABR rate feedback. 0 = default: the per-frame "
              "ABR law, byte-identical to the reference"),
    ]


def dec_params():
    return [
        Param("out420p", 0, 0, 1, None, "convert output to 4:2:0"),
        Param("drawinfo", 0, 0, 7, None,
              "draw debug info: 1=stability 2=motion vecs 4=intra blocks"),
    ]


def _usage(params, mode):
    print(HEADER)
    print(f"usage: python -m dsv1_tpu_torch.cli {mode} [options]")
    for p in params:
        print(f"\t-{p.prefix} : {p.desc}  [min={p.vmin}, max={p.vmax}]")
    print("\t-inp_ : REQUIRED input file")
    print("\t-out_ : REQUIRED output file")
    print("\t-y : overwrite without prompting")
    print("\t-l<n> : log level")
    print("\t-v : verbose")
    print("\t-prof_ : write a torch.profiler trace to this directory")


def _parse(argv, params):
    opts = {"inp": None, "out": None, "y": False, "v": False, "l": 2,
            "prof": None}
    table = {p.prefix: p for p in params}
    for a in argv:
        if not a.startswith("-"):
            print(f"strange argument: {a}")
            return None
        a = a[1:]
        if a in ("v", "y"):
            opts[a] = True
            continue
        if a.startswith("l") and a[1:].isdigit():
            opts["l"] = int(a[1:])
            continue
        if a.startswith(("inp_", "out_", "prof_")):
            key, val = a.split("_", 1)
            opts[key] = val
            continue
        for pref in sorted(table, key=len, reverse=True):
            if a.startswith(pref):
                try:
                    v = int(a[len(pref):])
                except ValueError:
                    print(f"error reading argument: {pref}")
                    return None
                p = table[pref]
                v = max(p.vmin, min(v, p.vmax))
                p.value = p.convert(v) if p.convert else v
                break
        else:
            print(f"unrecognized argument: -{a}")
            return None
    return opts


def _get(params, name):
    for p in params:
        if p.prefix == name:
            return p.value
    return 0


@contextlib.contextmanager
def _profile(path):
    """torch.profiler over the block, its trace written to path/."""
    if not path:
        yield
        return
    from pathlib import Path

    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    Path(path).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(path) / "trace.json"))


def _config(params):
    """(Metadata, EncoderConfig, whether the GOP-parallel encoder runs,
    abr_mode) of parsed encode parameters."""
    w, h = _get(params, "w"), _get(params, "h")
    subsamp = _get(params, "fmt")
    meta = Metadata(w, h, subsamp, _get(params, "fps_num"),
                    _get(params, "fps_den"), _get(params, "aspect_num"),
                    _get(params, "aspect_den"))
    gop = _get(params, "gop")
    quality = _get(params, "qp")
    rc_mode = _get(params, "rc_mode")
    kbps = _get(params, "kbps")
    if kbps == AUTO_BITRATE:
        bitrate = estimate_bitrate(quality * 100 // C.MAX_QUALITY, gop, meta)
    else:
        bitrate = kbps
    if rc_mode == C.RATE_CONTROL_ABR:
        quality = max(0, min(quality * 3 // 2, C.MAX_QUALITY))
    stabref = _get(params, "stabref")
    if stabref == 0:
        stabref = max(1, min(gop - 1, 14))
    # effectively infinite GOPs (the reference's DSV_GOP_INF) and ABR at
    # gop 0 run on the sequential encoder, as in the JAX CLI
    par_rc = rc_mode == C.RATE_CONTROL_CRF or gop > 0
    use_par = bool(_get(params, "gopar")) and gop <= 4096 and par_rc
    abr_mode = "gop" if _get(params, "gopabr") else "exact"
    cfg = EncoderConfig(
        quality=quality, gop=gop, do_scd=bool(_get(params, "scd")),
        rc_mode=rc_mode,
        rc_high_motion_nudge=bool(_get(params, "rc_hmnudge")),
        bitrate=bitrate, max_q_step=_get(params, "maxqstep"),
        min_quality=_get(params, "minqp"), max_quality=_get(params, "maxqp"),
        min_I_frame_quality=_get(params, "iminqp"),
        intra_pct_thresh=_get(params, "ipct"),
        scene_change_delta=_get(params, "schdelta"),
        stable_refresh=stabref, pyramid_levels=_get(params, "pyrlevels"),
        effort=_get(params, "effort"))
    return meta, cfg, use_par, abr_mode


def encode_config(argv):
    """(Metadata, EncoderConfig, abr_mode) the CLI's encode builds from
    `argv` (its options after `e`; -inp_ and -out_ may be left out)."""
    params = enc_params()
    if _parse(argv, params) is None:
        raise ValueError(f"bad encode arguments: {argv}")
    meta, cfg, _use_par, abr_mode = _config(params)
    return meta, cfg, abr_mode


def encode_main(argv, device="cuda") -> int:
    params = enc_params()
    opts = _parse(argv, params)
    if opts is None or "help" in argv:
        _usage(params, "e")
        return 1
    if not opts["inp"] or not opts["out"]:
        print("inp or out was not specified!")
        _usage(params, "e")
        return 1
    meta, cfg, use_par, abr_mode = _config(params)
    w, h, subsamp = meta.width, meta.height, meta.subsamp
    frno = _get(params, "sfr")
    nfr = _get(params, "nfr")
    maxframe = frno + nfr if nfr > 0 else -1
    nencoded = 0

    def frames(f):
        # read from disk frame by frame; the GOP-parallel encoder takes a
        # GOP at a time, the sequential one a frame
        nonlocal frno, nencoded
        while maxframe <= 0 or frno < maxframe:
            with record_function("cli.read"):
                planes = read_frame(f, frno, w, h, subsamp)
            if planes is None:
                return
            if opts["v"]:
                print(f"encoding frame {frno}", end="\r", flush=True)
            frno += 1
            nencoded += 1
            yield planes

    with _profile(opts["prof"]), open(opts["inp"], "rb") as f:
        if use_par:
            out = encode_stream_gops(frames(f), meta, cfg, device,
                                     abr_mode=abr_mode)
        else:
            enc = Encoder(meta, cfg, device)
            enc.start()
            out = enc.encode_stream(frames(f))
    if opts["v"] and nencoded:
        fps = (meta.fps_num + meta.fps_den // 2) // meta.fps_den
        bpf = len(out) * 8 // nencoded
        print(f"\nencoded {len(out)} bytes @ {bpf * fps} bps, "
              f"{bpf * fps // 1024} kbps. fps = {fps}, bpf = {bpf}")
    with record_function("cli.write"), open(opts["out"], "wb") as f:
        f.write(out)
    return 0


def decode_main(argv, device="cuda") -> int:
    params = dec_params()
    opts = _parse(argv, params)
    if opts is None or "help" in argv:
        _usage(params, "d")
        return 1
    if not opts["inp"] or not opts["out"]:
        print("inp or out was not specified!")
        _usage(params, "d")
        return 1
    to420 = bool(_get(params, "out420p"))
    drawinfo = _get(params, "drawinfo")
    with open(opts["inp"], "rb") as f:
        stream = f.read()
    if drawinfo:
        # the overlay needs each picture's block data: the sequential path
        dec = Decoder(draw_info=drawinfo, device=device)
        decoded = dec.decode_stream(stream)
        get_meta = dec.get_metadata
    else:
        # streaming: the metadata is in meta_box before the first frame
        meta_box = {}
        decoded = iter_decode_gops(stream, device, meta_box=meta_box)
        get_meta = lambda: meta_box["meta"]  # noqa: E731
    with _profile(opts["prof"]), open(opts["out"], "wb") as f:
        for fno, planes in decoded:
            subsamp = get_meta().subsamp
            if to420 and subsamp != C.SUBSAMP_420:
                y, u, v = planes
                if subsamp == C.SUBSAMP_444:
                    u, v = conv444to422(u), conv444to422(v)
                if subsamp in (C.SUBSAMP_444, C.SUBSAMP_422):
                    u, v = conv422to420(u), conv422to420(v)
                planes = [y, u, v]
            if opts["v"]:
                print(f"decoded frame {fno}", end="\r", flush=True)
            with record_function("cli.write"):
                write_frame(f, fno, planes)
    if opts["v"]:
        print()
    return 0


def main(argv=None, device="cuda") -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0][:1] not in ("e", "d"):
        print(HEADER)
        print("usage: python -m dsv1_tpu_torch.cli <e|d> [options]")
        return 0
    if argv[0][0] == "e":
        return encode_main(argv[1:], device)
    return decode_main(argv[1:], device)


if __name__ == "__main__":
    sys.exit(main())
