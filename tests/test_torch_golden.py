"""The golden hashes the port is held to on the GPU (chip_smoke.py).

`dsv1_tpu_torch/data/golden.json` holds the SHA-256 of the JAX package's
stream and decode of the smoke clips, written by tools/torch_golden.py:
`cif` and `1080p` through `encode_stream_gops` (gop 12, qp 85 CRF, 24
frames), `cif_cli` and `4k_cli` through the CLI at its defaults
(per-frame ABR, auto bitrate), `1080p_seq_cli` (-gopar0, and its
-drawinfo7 decode) and `1080p_gop0_cli` (-gop0 -rc_mode1) through the
CLI's sequential and intra-only paths, `1080p_gopabr_cli` (-gopabr1,
GOP-granular ABR), and `1080p_effort_cli`, `4k_effort_cli` (-effort3)
and `1080p_effort_seq_cli` (-gopar0 -effort2), and the clips of
several GOPs a launch through `encode_stream_gops` with their own
arguments (`cif_batch`, `cif_batch_cut`, `1080p_gopabr_batch`,
utils/golden.py API). Here the CIF entries are
regenerated from JAX on the CPU and checked against the file, and the
port's CPU encode and decode (through `encode_stream_gops` or the CLI)
are checked against it, as is the port's intra-only 1080p CLI run; the
other 1080p and 4K entries are checked the same way in the slow tier."""

import os

import pytest
import torch

import dsv1_tpu_torch as dt
from dsv1_tpu_torch import cli
from dsv1_tpu_torch.utils import golden as g
from tools import torch_golden as tg

torch.set_num_threads(1)


def _check_jax(name):
    assert os.environ.get("JAX_PLATFORMS") == "cpu"
    entry = (tg.jax_cli_entry if g.CLIPS[name][4] is not None
             else tg.jax_entry)(name)
    assert entry == g.load()[name]


def _check_port(name):
    gold = g.load()[name]
    yuv, frames = g.clip_frames(name)
    assert g.sha(yuv) == gold["clip_sha256"]
    meta, cfg, kw = g.encode_args(name)
    stream = dt.encode_stream_gops(frames, meta, cfg, "cpu", **kw)
    assert len(stream) == gold["stream_bytes"]
    assert g.sha(stream) == gold["stream_sha256"]
    _m, dec = dt.decode_stream_gops(stream, device="cpu")
    assert g.sha(g.decoded_bytes(dec)) == gold["decode_sha256"]


def _check_port_cli(name, tmp_path):
    gold = g.load()[name]
    yuv, _frames = g.clip_frames(name)
    assert g.sha(yuv) == gold["clip_sha256"]
    inp, dsv, out = (tmp_path / f for f in ("in.yuv", "s.dsv", "o.yuv"))
    inp.write_bytes(yuv)
    assert cli.main(g.cli_encode_args(name, inp, dsv), device="cpu") == 0
    assert g.sha(dsv.read_bytes()) == gold["stream_sha256"]
    for key, extra in {"decode_sha256": (), **g.CLIPS[name][5]}.items():
        assert cli.main(g.cli_decode_args(dsv, out, extra),
                        device="cpu") == 0
        assert g.sha(out.read_bytes()) == gold[key]


def test_cif_golden_matches_jax():
    _check_jax("cif")


def test_port_cif_matches_golden():
    _check_port("cif")


def test_cif_cli_golden_matches_jax():
    _check_jax("cif_cli")


def test_port_cif_cli_matches_golden(tmp_path):
    _check_port_cli("cif_cli", tmp_path)


@pytest.mark.slow
def test_1080p_golden_matches_jax():
    _check_jax("1080p")


@pytest.mark.slow
def test_port_1080p_matches_golden():
    _check_port("1080p")


@pytest.mark.slow
def test_4k_cli_golden_matches_jax():
    _check_jax("4k_cli")


def test_port_1080p_gop0_cli_matches_golden(tmp_path):
    _check_port_cli("1080p_gop0_cli", tmp_path)


@pytest.mark.slow
def test_1080p_gop0_cli_golden_matches_jax():
    _check_jax("1080p_gop0_cli")


@pytest.mark.slow
def test_1080p_seq_cli_golden_matches_jax():
    _check_jax("1080p_seq_cli")


@pytest.mark.slow
def test_port_1080p_seq_cli_matches_golden(tmp_path):
    _check_port_cli("1080p_seq_cli", tmp_path)


@pytest.mark.slow
def test_1080p_gopabr_cli_golden_matches_jax():
    _check_jax("1080p_gopabr_cli")


@pytest.mark.slow
def test_port_1080p_gopabr_cli_matches_golden(tmp_path):
    _check_port_cli("1080p_gopabr_cli", tmp_path)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["1080p_effort_cli", "4k_effort_cli",
                                  "1080p_effort_seq_cli"])
def test_effort_cli_golden_matches_jax(name):
    _check_jax(name)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["1080p_effort_cli", "1080p_effort_seq_cli"])
def test_port_effort_cli_matches_golden(name, tmp_path):
    _check_port_cli(name, tmp_path)


@pytest.mark.parametrize("name", ["cif_batch", "cif_batch_cut"])
def test_port_batch_matches_golden(name):
    _check_port(name)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["cif_batch", "cif_batch_cut",
                                  "1080p_gopabr_batch"])
def test_batch_golden_matches_jax(name):
    _check_jax(name)


@pytest.mark.slow
def test_port_1080p_gopabr_batch_matches_golden():
    _check_port("1080p_gopabr_batch")
