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
depth).
"""

import hashlib
import json
from pathlib import Path

import numpy as np

from ..constants import SUBSAMP_420
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
}


def load() -> dict:
    return json.loads(GOLDEN.read_text())


def sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def clip_frames(name: str):
    """(raw planar clip bytes, [(y, u, v), ...]) for a golden clip."""
    w, h, gen, n = CLIPS[name][:4]
    yuv = getattr(corpus, gen)(w, h, SUBSAMP_420, n, seed=SEED)
    return yuv, corpus.split_frames(yuv, w, h, SUBSAMP_420, n)


def cli_encode_args(name: str, inp, out) -> list:
    """argv of the CLI encode of a *_cli clip (after the program name)."""
    return ["e", f"-inp_{inp}", f"-out_{out}", *CLIPS[name][4], "-y"]


def cli_decode_args(inp, out, extra=()) -> list:
    return ["d", f"-inp_{inp}", f"-out_{out}", *extra, "-y"]


def decoded_bytes(frames) -> bytes:
    """Decoded output as raw planar bytes, frames in stream order."""
    return b"".join(np.asarray(p, np.uint8).tobytes()
                    for _fno, planes in frames for p in planes)
