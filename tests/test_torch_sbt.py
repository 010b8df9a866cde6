"""PyTorch port vs JAX: forward and inverse subband transforms, intra (B4T
level 1, even dims) and inter (Haar), luma (filtered inverse) and chroma,
even and odd sizes. Integer-exact: compared with assert_array_equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsv1_tpu.ops import sbt as jsbt
from dsv1_tpu_torch.ops import sbt as tsbt

torch.set_num_threads(1)

QUANT = 1540  # quality 25 %; coarse enough to exercise the hqp clamp


def _coefs(rng, h, w):
    return rng.integers(-128, 128, (h, w)).astype(np.int32)


@pytest.mark.parametrize("w,h,is_p", [
    (96, 80, False), (96, 80, True),
    (50, 42, False),                    # 4:2:0 CIF-like chroma, even
    (99, 83, True), (17, 9, True),      # odd dims (Haar only)
    (64, 2, False),
])
def test_fwd_sbt_matches_jax(w, h, is_p):
    a = _coefs(np.random.default_rng(w + h), h, w)
    want = np.asarray(jsbt.fwd_sbt(jnp.asarray(a), is_p=is_p))
    got = tsbt.fwd_sbt(torch.from_numpy(a), is_p).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("w,h,is_p", [
    (96, 80, False), (96, 80, True), (50, 42, False), (99, 83, True),
    (17, 9, True),
])
@pytest.mark.parametrize("is_luma", [True, False])
def test_inv_sbt_matches_jax(w, h, is_p, is_luma):
    rng = np.random.default_rng(3 * w + h)
    # transformed coefficients with a sparse, quantised-looking spread
    a = np.asarray(jsbt.fwd_sbt(jnp.asarray(_coefs(rng, h, w)), is_p=is_p))
    a = np.where(rng.random(a.shape) < 0.3, a, 0).astype(np.int32)
    want = np.asarray(jsbt.inv_sbt(jnp.asarray(a), QUANT, is_p=is_p,
                                   is_luma=is_luma))
    got = tsbt.inv_sbt(torch.from_numpy(a), QUANT, is_p, is_luma).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tsbt.coefs_to_plane(torch.from_numpy(want)).numpy(),
        np.asarray(jsbt.coefs_to_plane(jnp.asarray(want))))
