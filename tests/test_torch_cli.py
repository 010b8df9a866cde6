"""PyTorch port vs JAX: the CLI, byte for byte.

The same argv through `dsv1_tpu.cli.main` and
`dsv1_tpu_torch.cli.main(..., device="cpu")` must write the same .dsv
and, decoded by each CLI, the same YUV: at the CLI defaults (per-frame
ABR, auto bitrate, gop 12), with CRF (-rc_mode1), 4:4:4 input decoded
with -out420p1, GOP-granular ABR (-gopabr1) on 4:2:2 input, and on the
sequential paths: -gopar0, intra-only -gop0 (CRF through the
GOP-parallel encoder, ABR through the sequential Encoder), -gop5000 and
the -drawinfo7 overlay decode. -effort runs on every path
(tests/test_torch_effort.py)."""

import pytest
import torch

from dsv1_tpu import cli as jcli
import dsv1_tpu_torch as dt
from dsv1_tpu_torch import cli as tcli

from . import corpus

torch.set_num_threads(1)

W, H, N = 96, 80, 14


@pytest.mark.parametrize("fmt,extra,dec_extra", [
    (2, [], []),                     # CLI defaults: ABR, auto bitrate
    (2, ["-rc_mode1"], []),          # CRF
    (0, [], ["-out420p1"]),          # 4:4:4 in, 4:2:0 out
])
def test_cli_matches_jax(tmp_path, fmt, extra, dec_extra):
    subsamp = {0: dt.SUBSAMP_444, 1: dt.SUBSAMP_422, 2: dt.SUBSAMP_420}[fmt]
    (tmp_path / "in.yuv").write_bytes(
        corpus.make_clip(W, H, subsamp, N, seed=21))
    enc = [f"-inp_{tmp_path}/in.yuv", f"-w{W}", f"-h{H}", f"-fmt{fmt}",
           "-y", *extra]
    for tag, main in (("jax", jcli.main),
                      ("port", lambda a: tcli.main(a, device="cpu"))):
        assert main(["e", *enc, f"-out_{tmp_path}/{tag}.dsv"]) == 0
        # each CLI decodes the JAX stream
        assert main(["d", f"-inp_{tmp_path}/jax.dsv",
                     f"-out_{tmp_path}/{tag}.yuv", "-y", *dec_extra]) == 0
    stream = (tmp_path / "jax.dsv").read_bytes()
    assert (tmp_path / "port.dsv").read_bytes() == stream
    dec = (tmp_path / "jax.yuv").read_bytes()
    assert len(dec) == N * W * H * 3 // 2
    assert (tmp_path / "port.yuv").read_bytes() == dec


def test_cli_profile_trace(tmp_path):
    """-prof_DIR writes a torch.profiler trace of the encode there."""
    (tmp_path / "in.yuv").write_bytes(corpus.make_clip(48, 32, 0x5, 2,
                                                       seed=3))
    assert tcli.main(["e", f"-inp_{tmp_path}/in.yuv", "-w48", "-h32",
                      f"-out_{tmp_path}/s.dsv", f"-prof_{tmp_path}/prof",
                      "-y"], device="cpu") == 0
    assert (tmp_path / "s.dsv").stat().st_size > 0
    assert "gop.recon_chain" in (tmp_path / "prof" / "trace.json") \
        .read_text()


@pytest.mark.parametrize("extra,dec_extra", [
    (["-gopar0"], []),               # the sequential Encoder, ABR gop 12
    (["-gop0", "-rc_mode1"], []),    # intra only, encode_stream_gops
    (["-gop0"], []),                 # intra-only ABR: the Encoder
    (["-gop5000"], []),              # an effectively infinite GOP
    ([], ["-drawinfo7"]),            # the overlay: the sequential Decoder
])
def test_cli_sequential_matches_jax(tmp_path, extra, dec_extra):
    test_cli_matches_jax(tmp_path, 2, extra, dec_extra)


def test_cli_gopabr_matches_jax(tmp_path):
    """-gopabr1 on 4:2:2 input, decoded to 4:2:0: a GOP of 12 and a tail
    GOP of 2 frames, which both packages pad to 12 for the overflow
    verdict."""
    test_cli_matches_jax(tmp_path, 1, ["-gopabr1"], ["-out420p1"])
