"""The frozen reference against a witness of its own: the JAX package's
golden hashes (dsv1_tpu_torch/data/golden.json, read as data; nothing of
the JAX package or of JAX is imported). Each clip is made at seed 11,
checked against the golden clip hash, encoded by the reference (through
`encode_stream_gops` or its CLI) and decoded again, and the stream and
the decode are held to the JAX package's hashes. The CIF clips run on
the CPU; the 1080p clip (the crf_1080p cells' path) and the 4K CLI clip
(the abr_4k_cli cell's path) run on the card."""

import hashlib
import json

import numpy as np
import pytest
import torch

import dsvref
from dsvref import cli
from harness import corpus
from harness.spec import ROOT

GOLDEN = ROOT / "dsv1_tpu_torch" / "data" / "golden.json"
SEED = 11


def make_clip(w, h, subsamp, nframes, seed=0, cut_at=-1):
    """Moving textured square over a noisy gradient, planar bytes: a copy
    of the program's `utils/corpus.py make_clip`, held to the golden clip
    hashes below. cut_at >= 0 halves the luma from that frame on (a hard
    scene cut)."""
    rng = np.random.default_rng(seed)
    cw, ch = corpus.plane_dims(w, h, subsamp)
    frames = []
    base = (np.linspace(0, 200, w)[None, :]
            + np.linspace(0, 55, h)[:, None]).astype(np.int32)
    tex = rng.integers(-18, 18, (h, w))
    for i in range(nframes):
        y = base + tex
        sx, sy = (13 + 5 * i) % max(w - 24, 1), (11 + 3 * i) % max(h - 24, 1)
        y = y.copy()
        y[sy:sy + 20, sx:sx + 20] += 60
        y = np.roll(y, i, axis=1)
        y = np.clip(y + rng.integers(-4, 4, (h, w)), 0, 255).astype(np.uint8)
        if 0 <= cut_at <= i:
            y >>= 1
        u = np.clip(110 + rng.integers(-9, 9, (ch, cw)) + (i * 2), 0,
                    255).astype(np.uint8)
        v = np.clip(135 + rng.integers(-9, 9, (ch, cw)), 0,
                    255).astype(np.uint8)
        frames += [y.tobytes(), u.tobytes(), v.tobytes()]
    return b"".join(frames)


# name: (clip generator, its extra arguments, whether the CLI encodes it,
# whether it needs the card)
CLIPS = {
    "cif": (make_clip, {}, False, False),
    "cif_batch": (make_clip, {}, False, False),
    "cif_batch_cut": (make_clip, {"cut_at": 18}, False, False),
    "cif_cli": (make_clip, {}, True, False),
    "1080p": (corpus.make_rich_clip, {}, False, True),
    "4k_cli": (corpus.make_rich_clip, {}, True, True),
}


def sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def decoded_bytes(frames) -> bytes:
    return b"".join(np.asarray(p, np.uint8).tobytes()
                    for _fno, planes in frames for p in planes)


@pytest.mark.parametrize("name", [n for n, c in CLIPS.items() if not c[3]])
def test_reference_matches_the_goldens_on_the_cpu(name, tmp_path):
    torch.set_num_threads(2)
    check_golden(name, "cpu", tmp_path)


@pytest.mark.card
@pytest.mark.parametrize("name", [n for n, c in CLIPS.items() if c[3]])
def test_reference_matches_the_goldens_on_the_card(name, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    check_golden(name, "cuda", tmp_path)


def check_golden(name: str, dev: str, tmp_path):
    gold = json.loads(GOLDEN.read_text())[name]
    gen, kw, by_cli, _card = CLIPS[name]
    w, h, n = gold["width"], gold["height"], gold["frames"]
    assert gold["seed"] == SEED
    yuv = gen(w, h, 5, n, seed=SEED, **kw)
    assert sha(yuv) == gold["clip_sha256"]
    if by_cli:
        inp, out = tmp_path / "in.yuv", tmp_path / "out.dsv"
        inp.write_bytes(yuv)
        argv = [gold["argv"][0], f"-inp_{inp}", f"-out_{out}",
                *gold["argv"][1:]]
        assert cli.main(argv, device=dev) == 0
        stream = out.read_bytes()
    else:
        cfg = (gold["encode"]["config"] if "encode" in gold else
               {"quality": dsvref.quality_percent(gold["quality_pct"]),
                "gop": gold["gop"], "stable_refresh": gold["gop"] - 1})
        frames = corpus.split_frames(yuv, w, h, 5, n)
        stream = dsvref.encode_stream_gops(
            frames, dsvref.Metadata(w, h, 5), dsvref.EncoderConfig(**cfg),
            dev)
    assert len(stream) == gold["stream_bytes"]
    assert sha(stream) == gold["stream_sha256"]
    _meta, dec = dsvref.decode_stream_gops(stream, dev)
    assert len(dec) == n
    assert sha(decoded_bytes(dec)) == gold["decode_sha256"]
