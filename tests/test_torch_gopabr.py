"""PyTorch port vs JAX: GOP-granular ABR (-gopabr1), byte for byte.

The JAX package sets each GOP's quality from a host model of the
rate-quality curve (`_AbrState`) when the GOP enters its prefetch
pipeline (`_pipelined`), and calibrates the model on the first GOP whose
compacted planes fit their caps: the bytes depend on that schedule and
on the compaction's overflow verdicts. The port replays both. On the
96x80 -gop4 clip the CLI starts at quality 2047 (85 % x 3/2, clipped),
where GOP 0's P planes overflow the sparse cap, so calibration runs on
GOP 1; the port's stream and decode must equal the JAX CLI's."""

import math

import pytest
import torch

from dsv1_tpu import cli as jcli
from dsv1_tpu.models.encoder import EncoderConfig as JConfig
from dsv1_tpu.models.metadata import Metadata as JMeta
from dsv1_tpu.parallel import gop as jgop
from dsv1_tpu_torch import cli as tcli
import dsv1_tpu_torch as dt
from dsv1_tpu_torch.parallel import gop as tgop
from dsv1_tpu_torch.utils.stats import STATS

from . import corpus

torch.set_num_threads(1)

W, H, N = 96, 80, 16


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX CLI's and the port's -gopabr1 encode of the clip, and each
    CLI's decode of the JAX stream; the port's path counts."""
    td = tmp_path_factory.mktemp("gopabr")
    (td / "in.yuv").write_bytes(corpus.make_clip(W, H, dt.SUBSAMP_420, N,
                                                 seed=21))
    enc = [f"-inp_{td}/in.yuv", f"-w{W}", f"-h{H}", "-gop4", "-gopabr1",
           "-y"]
    out = {}
    for tag, main in (("jax", jcli.main),
                      ("port", lambda a: tcli.main(a, device="cpu"))):
        STATS.clear()
        assert main(["e", *enc, f"-out_{td}/{tag}.dsv"]) == 0
        out[f"{tag}_stats"] = dict(STATS)
        assert main(["d", f"-inp_{td}/jax.dsv", f"-out_{td}/{tag}.yuv",
                     "-y"]) == 0
        out[tag] = ((td / f"{tag}.dsv").read_bytes(),
                    (td / f"{tag}.yuv").read_bytes())
    return out


def test_gopabr_stream_matches_jax(runs):
    assert runs["port"][0] == runs["jax"][0]


def test_gopabr_decode_matches_jax(runs):
    assert len(runs["jax"][1]) == N * W * H * 3 // 2
    assert runs["port"][1] == runs["jax"][1]


def test_gopabr_calibrates_after_overflow(runs):
    """GOP 0 overflowed its caps and was packed dense, so the model was
    calibrated on GOP 1, whose recon chain ran twice (HME once)."""
    st = runs["port_stats"]
    assert st["calibration_gop"] == 1
    assert st["overflow_redos"] >= 1
    assert st["hme_calls"] == N // 4
    assert st["core_i"] + st["core_p"] == N + 4


def _feed(cls, cfg, meta, sizes):
    """Qualities a controller gives while the GOP sizes come in."""
    rate = cls(cfg, meta)
    got = []
    for n, size in sizes:
        quants, quals = rate.gop_quants(*(() if cls is tgop._AbrState
                                          else (1, 1, 4)))
        q = int(quals[1] if cls is tgop._AbrState else quals[0, 1])
        got.append(q)
        rate.gop_done(q, size, n)
    return got


@pytest.mark.parametrize("quality,sizes", [
    (2047, [(4, 90000), (4, 60000), (4, 30000), (4, 5000), (3, 100)]),
    (1200, [(12, 1000), (12, 1000), (12, 400000), (1, 9)]),
])
def test_abr_state_matches_jax(quality, sizes):
    kw = dict(quality=quality, bitrate=300 * 1024, min_quality=20,
              max_quality=2047, min_I_frame_quality=102)
    want = _feed(jgop._AbrState, JConfig(**kw),
                 JMeta(W, H, dt.SUBSAMP_420), sizes)
    got = _feed(tgop._AbrState, dt.EncoderConfig(**kw),
                dt.Metadata(W, H, dt.SUBSAMP_420), sizes)
    assert got == want
    assert len(set(got)) > 1 and not math.isnan(sum(got))


class _Reader:
    """The JAX pipeline's chunk reader over n numbered items."""

    def __init__(self, n):
        self.i, self.n = 0, n

    def next_chunk(self, _k):
        if self.i >= self.n:
            return None
        self.i += 1
        return self.i - 1


def test_pipelined_schedule_matches_jax():
    """Which items each item sees done when it is dispatched, with the
    depth held at 1 until two items are done, then 2."""
    def schedule(run):
        done, seen = [], []

        def depth():
            return 1 if len(done) < 2 else 2
        for item, at in run(lambda _i: list(done), depth):
            seen.append((item, at))
            done.append(item)
        return seen

    want = schedule(lambda d, f: jgop._pipelined(_Reader(7), 1, d, f))
    got = schedule(lambda d, f: tgop._pipelined(range(7), d, f))
    assert got == want
    assert got[3] == (3, [0, 1])
