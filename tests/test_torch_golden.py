"""The golden hashes the port is held to on the GPU (chip_smoke.py).

`dsv1_tpu_torch/data/golden.json` holds the SHA-256 of the JAX package's
stream and decode of the CIF and 1080p smoke clips (gop 12, qp 85 CRF,
24 frames), written by tools/torch_golden.py. Here the CIF entry is
regenerated from JAX on the CPU and checked against the file, and the
port's CPU encode and decode are checked against it; the 1080p entry is
checked the same way in the slow tier."""

import json
import os
from pathlib import Path

import pytest
import torch

import dsv1_tpu_torch as dt
from tools import torch_golden as tg

torch.set_num_threads(1)

GOLDEN = Path(dt.__file__).resolve().parent / "data" / "golden.json"


def _golden(name):
    return json.loads(GOLDEN.read_text())[name]


def _check_jax(name):
    assert os.environ.get("JAX_PLATFORMS") == "cpu"
    assert tg.jax_entry(name) == _golden(name)


def _check_port(name):
    gold = _golden(name)
    yuv, frames = tg.clip_frames(name)
    assert tg.sha(yuv) == gold["clip_sha256"]
    meta = dt.Metadata(gold["width"], gold["height"], dt.SUBSAMP_420)
    cfg = dt.EncoderConfig(quality=dt.quality_percent(tg.QUALITY_PCT),
                           gop=tg.GOP, stable_refresh=tg.GOP - 1)
    stream = dt.encode_stream_gops(frames, meta, cfg, device="cpu")
    assert len(stream) == gold["stream_bytes"]
    assert tg.sha(stream) == gold["stream_sha256"]
    _m, dec = dt.decode_stream_gops(stream, device="cpu")
    assert tg.sha(tg.decoded_bytes(dec)) == gold["decode_sha256"]


def test_cif_golden_matches_jax():
    _check_jax("cif")


def test_port_cif_matches_golden():
    _check_port("cif")


@pytest.mark.slow
def test_1080p_golden_matches_jax():
    _check_jax("1080p")


@pytest.mark.slow
def test_port_1080p_matches_golden():
    _check_port("1080p")
