"""PyTorch port vs JAX: GOP-granular ABR (`abr_mode="gop"`) in chunks of
GOPs.

All GOPs of a chunk share one quality, set when the chunk enters the
JAX package's prefetch pipeline; the rate model is calibrated on the
first chunk whose compacted planes fit their caps (padded GOPs count in
that verdict) and fed one point per real GOP. So the chunk decides the
bytes: the port at 1 and at 2 GOPs a chunk must give the JAX package's
stream at the same chunk, and the JAX package's two streams differ."""

from dataclasses import asdict

import pytest
import torch

from dsv1_tpu.constants import SUBSAMP_420
from dsv1_tpu.models.encoder import EncoderConfig as JConfig
from dsv1_tpu.models.metadata import Metadata as JMeta
from dsv1_tpu.parallel import encode_stream_gops as jencode
import dsv1_tpu_torch as dt
from dsv1_tpu_torch.cli import encode_config
from dsv1_tpu_torch.utils import corpus as tcorpus
from dsv1_tpu_torch.utils.stats import STATS

torch.set_num_threads(1)

W, H = 96, 80


def _frames(n, seed=21):
    yuv = tcorpus.make_clip(W, H, SUBSAMP_420, n, seed=seed)
    return tcorpus.split_frames(yuv, W, H, SUBSAMP_420, n)


@pytest.fixture(scope="module")
def gopabr():
    """A 20-frame clip (five GOPs of 4: at 2 GOPs a chunk the tail chunk
    is one real GOP and a padded one) at the CLI's -gopabr1 settings,
    and the JAX package's streams at 1 and 2 GOPs a chunk."""
    frames = _frames(20)
    meta, cfg, mode = encode_config([f"-w{W}", f"-h{H}", "-gop4",
                                     "-gopabr1"])
    assert mode == "gop"
    jax = {gpd: jencode(frames, JMeta(**asdict(meta)), JConfig(**asdict(cfg)),
                        gops_per_device=gpd, abr_mode="gop")
           for gpd in (1, 2)}
    return frames, meta, cfg, jax


@pytest.mark.parametrize("gpd", [1, 2])
def test_gopabr_chunks_match_jax(gopabr, gpd):
    frames, meta, cfg, jax = gopabr
    STATS.clear()
    got = dt.encode_stream_gops(frames, meta, cfg, "cpu", gpd,
                                abr_mode="gop")
    assert got == jax[gpd]
    assert STATS["chunks"] == (5 if gpd == 1 else 3)


def test_gopabr_chunk_decides_the_bytes(gopabr):
    """The chunk's GOPs share one quality: the JAX package's own streams
    at 1 and 2 GOPs a chunk differ."""
    _frames_, _meta, _cfg, jax = gopabr
    assert jax[1] != jax[2]
