"""Write the golden hashes that the PyTorch port is held to.

For the `cif` and `1080p` clips, encodes with the JAX package's
GOP-parallel CRF encoder on the CPU (gop 12, qp 85, stable_refresh 11)
and decodes with its GOP-parallel decoder; the `*_batch*` clips the
same way, with the config and the `gops_per_device` / `abr_mode`
arguments that `API` of dsv1_tpu_torch/utils/golden.py gives them. For
the `*_cli` clips, runs `python -m dsv1_tpu.cli e` with the clip's
arguments (the defaults: per-frame ABR, auto bitrate, gop 12) and `d`,
plus each extra decode the clip lists (`-drawinfo7` for
`1080p_seq_cli`), under JAX_PLATFORMS=cpu. Records the SHA-256 of the
input clip, of the stream and of each decode in
`dsv1_tpu_torch/data/golden.json`. `chip_smoke.py` and
`tests/test_torch_golden.py` check the port against that file. The
clips and their settings are `dsv1_tpu_torch/utils/golden.py`; only
this script's JAX half imports `dsv1_tpu`. The 4K CLI clip and the two
1080p CLI clips take minutes each and a few GB of host memory.

    JAX_PLATFORMS=cpu python tools/torch_golden.py [--only NAME]
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from dsv1_tpu_torch.utils.golden import (API, CLIPS, GOLDEN,  # noqa: E402
                                         QUALITY_PCT, SEED, clip_frames,
                                         cli_decode_args, cli_encode_args,
                                         decoded_bytes, encode_args, sha)


def jax_entry(name: str) -> dict:
    """Golden entry for one encode_stream_gops clip, computed with the
    JAX package."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    from dataclasses import asdict

    from dsv1_tpu.models.encoder import EncoderConfig
    from dsv1_tpu.models.metadata import Metadata
    from dsv1_tpu.parallel import decode_stream_gops, encode_stream_gops

    w, h, _gen, n = CLIPS[name][:4]
    yuv, frames = clip_frames(name)
    meta, cfg, kw = encode_args(name)
    stream = encode_stream_gops(frames, Metadata(**asdict(meta)),
                                EncoderConfig(**asdict(cfg)), **kw)
    _meta, dec = decode_stream_gops(stream)
    entry = {"width": w, "height": h, "frames": n, "seed": SEED,
             "gop": cfg.gop, "quality_pct": QUALITY_PCT,
             "clip_sha256": sha(yuv), "stream_sha256": sha(stream),
             "stream_bytes": len(stream),
             "decode_sha256": sha(decoded_bytes(dec))}
    if name in API:
        entry["encode"] = {**API[name], "config": asdict(cfg)}
    return entry


def jax_cli_entry(name: str) -> dict:
    """Golden entry for one *_cli clip: the JAX CLI's `e` then each `d`,
    each in its own process on the CPU."""
    w, h, _gen, n, _args, extra_decodes = CLIPS[name]
    yuv, _frames = clip_frames(name)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    decodes = {"decode_sha256": (), **extra_decodes}
    with tempfile.TemporaryDirectory() as td:
        inp, dsv, out = (Path(td) / f for f in ("in.yuv", "s.dsv", "o.yuv"))
        inp.write_bytes(yuv)
        enc = cli_encode_args(name, inp, dsv)
        subprocess.run([sys.executable, "-m", "dsv1_tpu.cli", *enc],
                       cwd=ROOT, env=env, check=True)
        stream = dsv.read_bytes()
        entry = {"width": w, "height": h, "frames": n, "seed": SEED,
                 "argv": [a for a in enc if not a.startswith(("-inp_",
                                                              "-out_"))],
                 "clip_sha256": sha(yuv), "stream_sha256": sha(stream),
                 "stream_bytes": len(stream)}
        for key, extra in decodes.items():
            subprocess.run([sys.executable, "-m", "dsv1_tpu.cli",
                            *cli_decode_args(dsv, out, extra)],
                           cwd=ROOT, env=env, check=True)
            entry[key] = sha(out.read_bytes())
            if extra:
                entry[key.replace("_sha256", "_argv")] = list(extra)
        return entry


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=sorted(CLIPS), default=None)
    args = ap.parse_args()
    golden = json.loads(GOLDEN.read_text()) if GOLDEN.exists() else {}
    for name in ([args.only] if args.only else list(CLIPS)):
        cli = CLIPS[name][4] is not None
        golden[name] = jax_cli_entry(name) if cli else jax_entry(name)
        print(name, json.dumps(golden[name]), flush=True)
        GOLDEN.write_text(json.dumps(golden, indent=1, sort_keys=True)
                          + "\n")


if __name__ == "__main__":
    main()
