"""PyTorch port vs JAX: subband column tiles (parallel/tile.py) and the
gop x tile encode.

The port's tiles lie on `["cpu"] * D`, the JAX package's frames are laid
out over the first D of the 8 virtual CPU devices as tests/test_tile.py
lays them out:

- `fwd_sbt_tiled`, `inv_sbt_tiled` (luma and chroma, quants 137 and
  1024) and `encode_plane_tiled` at D = 2, 4 and 8 on 256x192 and
  352x288 planes, P and I, against `dsv1_tpu.parallel.tile` itself
  (one case of each in tier-1 at D = 4, the rest `slow`);
- `_replicate_level` against the JAX rule;
- the gop x tile encode on `gop_tile_mesh(2, 4)` and `(4, 2)` against
  the JAX package's single-device bytes (its own test_tile.py shows its
  tiled bytes equal them), and the tiled functions' plain Haar levels
  counted per tile on the CPU (no launches here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from dsv1_tpu.constants import RATE_CONTROL_CRF, SUBSAMP_420, quality_percent
from dsv1_tpu.models.encoder import EncoderConfig
from dsv1_tpu.models.metadata import Metadata
from dsv1_tpu.ops import sbt as jsbt
from dsv1_tpu.parallel import encode_stream_gops
from dsv1_tpu.parallel import tile as jtile
import dsv1_tpu_torch as dt
from dsv1_tpu_torch.parallel import tile as ttile

from .test_tile import _clip, _rand_coefs

torch.set_num_threads(1)


def _meshes(D):
    return jtile.tile_mesh(jax.devices()[:D]), dt.tile_mesh(["cpu"] * D)


def _both(a, D):
    jm, tm = _meshes(D)
    return (jm, tm, jax.device_put(a, NamedSharding(jm, P(None, "tile"))),
            dt.split_tiles(torch.from_numpy(a), tm))


def _cases(fast):
    out = []
    for D in (2, 4, 8):
        for w, h in ((256, 192), (352, 288)):
            for is_p in (False, True):
                marks = () if (D, w) == fast else (pytest.mark.slow,)
                out.append(pytest.param(D, w, h, is_p, marks=marks))
    return out


@pytest.mark.parametrize("D,w,h,is_p", _cases((4, 352)))
def test_fwd_sbt_tiled_matches_jax(D, w, h, is_p):
    a = _rand_coefs(h, w, seed=w + D + is_p)
    jm, tm, ja, ta = _both(a, D)
    want = np.asarray(jtile.fwd_sbt_tiled(ja, is_p, jm))
    got = dt.fwd_sbt_tiled(ta, is_p, tm)
    assert [t.shape[-1] for t in got] == [w // D] * D
    np.testing.assert_array_equal(dt.join_tiles(got).numpy(), want)


@pytest.mark.parametrize("q", [137, 1024])
@pytest.mark.parametrize("D,w,h,is_p", _cases((4, 352)))
def test_inv_sbt_tiled_matches_jax(D, w, h, is_p, q):
    a = _rand_coefs(h, w, seed=3 * w + D + is_p + q)
    jm, tm, ja, ta = _both(a, D)
    for luma in (True, False):
        want = np.asarray(jtile.inv_sbt_tiled(ja, q, is_p, luma, jm))
        got = dt.inv_sbt_tiled(ta, q, is_p, luma, tm)
        np.testing.assert_array_equal(dt.join_tiles(got).numpy(), want,
                                      err_msg=f"luma {luma}")


@pytest.mark.parametrize("D,w,h,is_p", _cases((4, 352)))
def test_encode_plane_tiled_matches_jax(D, w, h, is_p):
    nbh, nbv = -(-w // 16), -(-h // 16)
    a = _rand_coefs(h, w, seed=9 + is_p + D, lo=-128, hi=128)
    stable = np.random.default_rng(5).integers(0, 4, nbh * nbv) \
        .astype(np.uint8)
    jm, tm, ja, ta = _both(a, D)
    qv_j, dc_j, rec_j = jtile.encode_plane_tiled(ja, 512, is_p, 0, stable,
                                                 nbh, nbv, jm)
    qv_t, dc_t, rec_t = dt.encode_plane_tiled(ta, 512, is_p, 0,
                                              torch.from_numpy(stable), nbh,
                                              nbv, tm)
    np.testing.assert_array_equal(qv_t.numpy(), np.asarray(qv_j))
    assert int(dc_t) == int(dc_j)
    np.testing.assert_array_equal(dt.join_tiles(rec_t).numpy(),
                                  np.asarray(rec_j))


@pytest.mark.parametrize("W,H", [(256, 192), (352, 288), (1920, 1080),
                                 (176, 144), (960, 540), (360, 200),
                                 (96, 80), (3840, 2160)])
def test_replicate_level_matches_jax(W, H):
    lv = jsbt.nlevels(W, H)
    for D in (1, 2, 3, 4, 8):
        assert ttile._replicate_level(W, H, lv, D) == \
            jtile._replicate_level(W, H, lv, D)


def test_split_tiles_raises_on_uneven_widths():
    with pytest.raises(ValueError, match="does not split"):
        dt.split_tiles(torch.zeros(8, 100, dtype=torch.int32),
                       dt.tile_mesh(["cpu"] * 8))


_SINGLE = {}


@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
def test_gop_tile_encode_matches_jax(shape):
    """tests/test_tile.py's clip (352x288, gop 3, 6 frames) through the
    port's gop x tile encode: the JAX package's single-device bytes."""
    w, h, G = 352, 288, 3
    frames = _clip(w, h, 2 * G)
    kw = dict(quality=quality_percent(85), gop=G, rc_mode=RATE_CONTROL_CRF,
              stable_refresh=G - 1)
    if "want" not in _SINGLE:
        _SINGLE["want"] = encode_stream_gops(
            frames, Metadata(w, h, SUBSAMP_420), EncoderConfig(**kw))
    got = dt.encode_stream_gops(frames, dt.Metadata(w, h, SUBSAMP_420),
                                dt.EncoderConfig(**kw),
                                mesh=dt.gop_tile_mesh(*shape,
                                                      ["cpu"] * 8))
    assert got == _SINGLE["want"]


def test_tiled_levels_run_per_tile():
    """On 352x288 at D = 4, each tile runs Haar levels 1..3 itself and
    the gathered tail levels 4..9: the tiles' pieces and the tail equal
    the untiled pyramid."""
    assert ttile._tiled_levels(352, 288, 4) == 3
    assert ttile._replicate_level(352, 288, 9, 4) == 4
    a = torch.from_numpy(_rand_coefs(288, 352, seed=2))
    tm = dt.tile_mesh(["cpu"] * 4)
    got = dt.join_tiles(dt.fwd_sbt_tiled(dt.split_tiles(a, tm), True, tm))
    want = np.asarray(jsbt.fwd_sbt(jnp.asarray(a.numpy()), True))
    np.testing.assert_array_equal(got.numpy(), want)
