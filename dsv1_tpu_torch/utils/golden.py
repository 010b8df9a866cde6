"""The golden clips the port is held to, and how their hashes are read.

`dsv1_tpu_torch/data/golden.json` holds, per clip, the SHA-256 of the
input clip, of the JAX package's stream and of its decode
(tools/torch_golden.py writes it). Two clips go through
`encode_stream_gops` at gop 12, qp 85 CRF; the `*_cli` clips go through
the CLI: `cif_cli` and `4k_cli` with its defaults (per-frame ABR, auto
bitrate, gop 12, the GOP-parallel encoder), `1080p_seq_cli` with
-gopar0 (the same ABR on the sequential Encoder; its -drawinfo7 decode
is hashed too), `1080p_gop0_cli` intra only (-gop0 -rc_mode1) and
`1080p_gopabr_cli` with -gopabr1 (GOP-granular ABR: three full GOPs and
the next GOP's I frame, so the rate model's pipeline reaches its full
depth). The `*_batch*` clips go through `encode_stream_gops` with the
arguments `API` gives them (`encode_args`): `cif_batch` at its default
chunk (4 GOPs a launch, then a tail GOP of 4 frames padded to a chunk),
`cif_batch_cut` with a hard cut in its second GOP and stable_refresh 4
(carried stability states, a frame index with P and intra frames), and
`1080p_gopabr_batch` with the CLI's -gopabr1 settings at 2 GOPs a chunk
(the chunk shares one quality, so its bytes differ from
`1080p_gopabr_cli`'s).
"""

import hashlib
import json
from pathlib import Path

import numpy as np

from ..constants import SUBSAMP_420, quality_percent
from . import corpus

GOLDEN = Path(__file__).resolve().parent.parent / "data" / "golden.json"
SEED = 11
GOP = 12
QUALITY_PCT = 85

# name: (width, height, clip generator, frames, CLI encode arguments or
# None for the encode_stream_gops clips, {hash name: extra CLI decode
# arguments} of the decodes hashed besides the default one). 4k_cli is
# one full GOP plus the next GOP's I frame, so the rate state and the
# stability accumulators carry across a GOP boundary; so is
# 1080p_seq_cli on the sequential Encoder.
CLIPS = {
    "cif": (352, 288, "make_clip", 24, None, {}),
    "1080p": (1920, 1080, "make_rich_clip", 24, None, {}),
    "cif_cli": (352, 288, "make_clip", 24, ("-w352", "-h288"), {}),
    "4k_cli": (3840, 2160, "make_rich_clip", 13, ("-w3840", "-h2160"), {}),
    "1080p_seq_cli": (1920, 1080, "make_rich_clip", 13,
                      ("-w1920", "-h1080", "-gopar0"),
                      {"drawinfo_sha256": ("-drawinfo7",)}),
    "1080p_gop0_cli": (1920, 1080, "make_rich_clip", 12,
                       ("-w1920", "-h1080", "-gop0", "-rc_mode1"), {}),
    "1080p_gopabr_cli": (1920, 1080, "make_rich_clip", 37,
                         ("-w1920", "-h1080", "-gopabr1"), {}),
    "1080p_effort_cli": (1920, 1080, "make_rich_clip", 13,
                         ("-w1920", "-h1080", "-effort3"), {}),
    "4k_effort_cli": (3840, 2160, "make_rich_clip", 13,
                      ("-w3840", "-h2160", "-effort3"), {}),
    "1080p_effort_seq_cli": (1920, 1080, "make_rich_clip", 13,
                             ("-w1920", "-h1080", "-gopar0", "-effort2"),
                             {}),
    "cif_batch": (352, 288, "make_clip", 52, None, {}),
    "cif_batch_cut": (352, 288, "make_clip", 40, None, {}),
    "1080p_gopabr_batch": (1920, 1080, "make_rich_clip", 37, None, {}),
}

# extra arguments of a clip's generator
GEN_KW = {"cif_batch_cut": {"cut_at": 18}}

# the encode_stream_gops clips beyond `cif` and `1080p`: EncoderConfig
# fields over the CRF defaults (or `cli`: the CLI arguments whose config
# the encode takes), gops_per_device and abr_mode
API = {
    "cif_batch": {},
    "cif_batch_cut": {"cfg": {"stable_refresh": 4}},
    "1080p_gopabr_batch": {"cli": ["-w1920", "-h1080", "-gopabr1"],
                           "gops_per_device": 2, "abr_mode": "gop"},
}


def load() -> dict:
    return json.loads(GOLDEN.read_text())


def sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def clip_frames(name: str):
    """(raw planar clip bytes, [(y, u, v), ...]) for a golden clip."""
    w, h, gen, n = CLIPS[name][:4]
    yuv = getattr(corpus, gen)(w, h, SUBSAMP_420, n, seed=SEED,
                               **GEN_KW.get(name, {}))
    return yuv, corpus.split_frames(yuv, w, h, SUBSAMP_420, n)


def encode_args(name: str):
    """(Metadata, EncoderConfig, keyword arguments of encode_stream_gops)
    of an encode_stream_gops clip, as the port's classes; the JAX
    package's take the same fields."""
    from ..cli import encode_config
    from ..models.encoder import EncoderConfig
    from ..models.metadata import Metadata
    w, h = CLIPS[name][:2]
    spec = API.get(name, {})
    kw = {k: spec[k] for k in ("gops_per_device", "abr_mode") if k in spec}
    if "cli" in spec:
        meta, cfg, _mode = encode_config(list(spec["cli"]))
        return meta, cfg, kw
    cfg = EncoderConfig(**{"quality": quality_percent(QUALITY_PCT),
                           "gop": GOP, "stable_refresh": GOP - 1,
                           **spec.get("cfg", {})})
    return Metadata(w, h, SUBSAMP_420), cfg, kw


def cli_encode_args(name: str, inp, out) -> list:
    """argv of the CLI encode of a *_cli clip (after the program name)."""
    return ["e", f"-inp_{inp}", f"-out_{out}", *CLIPS[name][4], "-y"]


def cli_decode_args(inp, out, extra=()) -> list:
    return ["d", f"-inp_{inp}", f"-out_{out}", *extra, "-y"]


def decoded_bytes(frames) -> bytes:
    """Decoded output as raw planar bytes, frames in stream order."""
    return b"".join(np.asarray(p, np.uint8).tobytes()
                    for _fno, planes in frames for p in planes)
