"""Write the golden hashes that the PyTorch port is held to.

Encodes the CIF and 1080p smoke clips with the JAX package's
GOP-parallel CRF encoder on the CPU (gop 12, qp 85, stable_refresh 11),
decodes each stream with the JAX GOP-parallel decoder, and records the
SHA-256 of the input clip, of the stream and of the decoded planes in
`dsv1_tpu_torch/data/golden.json`. `chip_smoke.py` and
`tests/test_torch_golden.py` check the port against that file.

    JAX_PLATFORMS=cpu python tools/torch_golden.py [--only cif|1080p]
"""

import argparse
import hashlib
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "dsv1_tpu_torch" / "data" / "golden.json"

# (name, width, height, clip generator) — the slice's two operating points
CLIPS = {
    "cif": (352, 288, "make_clip"),
    "1080p": (1920, 1080, "make_rich_clip"),
}
NFRAMES = 24
SEED = 11
GOP = 12
QUALITY_PCT = 85


def split_frames(yuv: bytes, w: int, h: int, subsamp: int, n: int):
    """Raw planar clip bytes -> [(y, u, v), ...] uint8 arrays (no jax)."""
    import numpy as np

    from dsv1_tpu.constants import (format_h_shift, format_v_shift,
                                    round_shift)

    cw = round_shift(w, format_h_shift(subsamp))
    ch = round_shift(h, format_v_shift(subsamp))
    ysz, csz = w * h, cw * ch
    fsz = ysz + 2 * csz
    frames = []
    for i in range(n):
        f = np.frombuffer(yuv[i * fsz:(i + 1) * fsz], np.uint8)
        frames.append((f[:ysz].reshape(h, w),
                       f[ysz:ysz + csz].reshape(ch, cw),
                       f[ysz + csz:].reshape(ch, cw)))
    return frames


def clip_frames(name: str):
    """(raw planar clip bytes, [(y, u, v), ...]) for a golden clip."""
    from dsv1_tpu.constants import SUBSAMP_420
    from tests import corpus

    w, h, gen = CLIPS[name]
    yuv = getattr(corpus, gen)(w, h, SUBSAMP_420, NFRAMES, seed=SEED)
    return yuv, split_frames(yuv, w, h, SUBSAMP_420, NFRAMES)


def sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def decoded_bytes(frames) -> bytes:
    """Decoded output as raw planar bytes, frames in stream order."""
    import numpy as np
    return b"".join(np.asarray(p, np.uint8).tobytes()
                    for _fno, planes in frames for p in planes)


def jax_entry(name: str) -> dict:
    """Golden entry for one clip, computed with the JAX package."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    from dsv1_tpu.constants import (RATE_CONTROL_CRF, SUBSAMP_420,
                                    quality_percent)
    from dsv1_tpu.models.encoder import EncoderConfig
    from dsv1_tpu.models.metadata import Metadata
    from dsv1_tpu.parallel import decode_stream_gops, encode_stream_gops

    w, h, _ = CLIPS[name]
    yuv, frames = clip_frames(name)
    cfg = EncoderConfig(quality=quality_percent(QUALITY_PCT), gop=GOP,
                        rc_mode=RATE_CONTROL_CRF, stable_refresh=GOP - 1)
    stream = encode_stream_gops(frames, Metadata(w, h, SUBSAMP_420), cfg)
    _meta, dec = decode_stream_gops(stream)
    return {"width": w, "height": h, "frames": NFRAMES, "seed": SEED,
            "gop": GOP, "quality_pct": QUALITY_PCT,
            "clip_sha256": sha(yuv), "stream_sha256": sha(stream),
            "stream_bytes": len(stream),
            "decode_sha256": sha(decoded_bytes(dec))}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=sorted(CLIPS), default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    golden = json.loads(GOLDEN.read_text()) if GOLDEN.exists() else {}
    for name in ([args.only] if args.only else list(CLIPS)):
        golden[name] = jax_entry(name)
        print(name, json.dumps(golden[name]), flush=True)
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    GOLDEN.write_text(json.dumps(golden, indent=1, sort_keys=True) + "\n")


if __name__ == "__main__":
    main()
