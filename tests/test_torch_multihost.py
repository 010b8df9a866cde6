"""PyTorch port vs JAX: the GOP-sharded encode across processes
(parallel/multihost.py).

Each process encodes a contiguous range of GOPs; the ranges' partial
streams, muxed with O(1) prev-link patches, must equal a one-process
encode, and the port's must equal the JAX package's: `shard_ranges`,
`encode_stream_multihost` with 2 and 3 shards and at gop 0, the shard
arguments of `encode_stream_gops` (a frame-number offset, no EOS, the
returned state) on both packers, a shard
resumed from a JAX `EncodedShard.stab_final` (a boundary that does not
fall on a stability refresh), and `run_distributed_shard` in two real
processes on torch.distributed (gloo on 127.0.0.1), where a scene cut
moves the refresh so that the ranks' handshake encodes again."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dsv1_tpu.constants import GOP_INTRA, SUBSAMP_420
from dsv1_tpu.models.encoder import EncoderConfig as JConfig
from dsv1_tpu.models.metadata import Metadata as JMeta
from dsv1_tpu.parallel import encode_stream_gops as jencode
from dsv1_tpu.parallel import multihost as jmh
import dsv1_tpu_torch as dt
from dsv1_tpu_torch.parallel import multihost as tmh
from dsv1_tpu_torch.utils import corpus as tcorpus
from dsv1_tpu_torch.utils.stats import STATS

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
W, H = 96, 80


def _frames(n, seed=31, cut_at=-1):
    yuv = tcorpus.make_clip(W, H, SUBSAMP_420, n, seed=seed, cut_at=cut_at)
    return tcorpus.split_frames(yuv, W, H, SUBSAMP_420, n)


@pytest.mark.parametrize("n,gop,shards", [(25, 4, 3), (8, 4, 5),
                                          (10, GOP_INTRA, 2), (7, 3, 2),
                                          (52, 12, 3)])
def test_shard_ranges_match_jax(n, gop, shards):
    assert tmh.shard_ranges(n, gop, shards) == jmh.shard_ranges(n, gop,
                                                                shards)


@pytest.mark.parametrize("shards", [2, 3])
def test_multihost_matches_jax(shards):
    """16 frames at gop 4, stable_refresh 3: 2 shards of 2 GOPs, or 3
    shards of 2, 2 and 0 GOPs."""
    frames = _frames(16)
    kw = dict(gop=4, stable_refresh=3)
    meta = dt.Metadata(W, H, SUBSAMP_420)
    got = tmh.encode_stream_multihost(frames, meta, dt.EncoderConfig(**kw),
                                      n_shards=shards, device="cpu")
    assert got == jmh.encode_stream_multihost(
        frames, JMeta(W, H, SUBSAMP_420), JConfig(**kw), n_shards=shards)
    assert got == dt.encode_stream_gops(frames, meta,
                                        dt.EncoderConfig(**kw), "cpu")


def test_multihost_gop0_matches_jax():
    frames = _frames(6, seed=9)
    meta = dt.Metadata(W, H, SUBSAMP_420)
    got = tmh.encode_stream_multihost(frames, meta,
                                      dt.EncoderConfig(gop=GOP_INTRA),
                                      n_shards=2, device="cpu")
    assert got == jmh.encode_stream_multihost(
        frames, JMeta(W, H, SUBSAMP_420), JConfig(gop=GOP_INTRA),
        n_shards=2)
    assert got == dt.encode_stream_gops(frames, meta,
                                        dt.EncoderConfig(gop=GOP_INTRA),
                                        "cpu")


def _noisy(n, seed=11):
    """n frames of noise: at quality 95 % their planes overflow the
    compaction caps, so the chunk is packed from its dense planes."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (H, W), dtype=np.uint8),
             rng.integers(0, 256, (H // 2, W // 2), dtype=np.uint8),
             rng.integers(0, 256, (H // 2, W // 2), dtype=np.uint8))
            for _ in range(n)]


@pytest.mark.parametrize("dense", [False, True])
def test_shard_arguments_match_jax(dense):
    """encode_stream_gops with a frame-number offset, no EOS and the
    returned state gives the JAX package's (stream, last picture length,
    (stability, refresh counter)), on the native chunk packer and on the
    dense packing of an overflowing chunk."""
    frames = _noisy(8) if dense else _frames(8)
    kw = dict(gop=4, stable_refresh=3, quality=dt.quality_percent(
        95 if dense else 85))
    extra = dict(_fnum_base=40, _emit_eos=False, _return_state=True)
    want = jencode(frames, JMeta(W, H, SUBSAMP_420), JConfig(**kw), **extra)
    STATS.clear()
    got = dt.encode_stream_gops(frames, dt.Metadata(W, H, SUBSAMP_420),
                                dt.EncoderConfig(**kw), "cpu", **extra)
    assert STATS["overflow_redos"] == int(dense)
    assert got[:2] == want[:2]
    assert got[2][1] == want[2][1]
    np.testing.assert_array_equal(got[2][0], want[2][0])


def test_jax_stab_final_resumes_in_the_port():
    """gop 6, stable_refresh 4: the first shard (2 GOPs) ends with its
    refresh counter between 0 and the period, so the second shard must
    start from that state. The port's first shard ends in JAX's state,
    and from JAX's EncodedShard.stab_final the port's second shard gives
    JAX's bytes (and differs from a start at zero)."""
    frames = _frames(24)
    kw = dict(gop=6, stable_refresh=4)
    jmeta, jcfg = JMeta(W, H, SUBSAMP_420), JConfig(**kw)
    meta, cfg = dt.Metadata(W, H, SUBSAMP_420), dt.EncoderConfig(**kw)
    j1 = jmh.encode_shard(frames[:12], jmeta, jcfg, first_gop=0)
    t1 = tmh.encode_shard(frames[:12], meta, cfg, first_gop=0, device="cpu")
    assert 0 < j1.stab_final[1] < 4
    assert t1.data == j1.data and t1.last_pic_len == j1.last_pic_len
    assert t1.stab_final[1] == j1.stab_final[1]
    assert (t1.stab_final[0] == j1.stab_final[0]).all()
    j2 = jmh.encode_shard(frames[12:], jmeta, jcfg, first_gop=2,
                          stab_init=j1.stab_final)
    t2 = tmh.encode_shard(frames[12:], meta, cfg, first_gop=2,
                          stab_init=j1.stab_final, device="cpu")
    assert t2.data == j2.data
    assert t2.data != tmh.encode_shard(frames[12:], meta, cfg, first_gop=2,
                                       device="cpu").data


def test_run_distributed_shard_in_two_processes(tmp_path):
    """Two processes (tools/torch_shard_worker.py), gloo on 127.0.0.1: a
    cut at frame 9 makes frame 9 intra, so the second rank's range does
    not start at a refresh and the handshake runs one round; rank 0's
    muxed stream equals the one-process encode."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    out = tmp_path / "mux.dsv"
    args = ["--size", f"{W}x{H}", "--frames", "22", "--gop", "6",
            "--stabref", "4", "--seed", "31", "--cut", "9", "--device",
            "cpu"]
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tools" / "torch_shard_worker.py"),
         f"127.0.0.1:{port}", "2", str(rank), str(out), *args],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], [e[-2000:]
                                                     for _, e in outs]
    assert all('"rounds": 1' in o for o, _ in outs)
    want = dt.encode_stream_gops(_frames(22, cut_at=9),
                                 dt.Metadata(W, H, SUBSAMP_420),
                                 dt.EncoderConfig(gop=6, stable_refresh=4),
                                 "cpu")
    assert out.read_bytes() == want
