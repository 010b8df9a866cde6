"""PyTorch port vs JAX: HZCC quantization with in-loop write-back
(qvals in traversal order and the written-back coefficients) and the
decode-side dequantization, including odd ceil dims whose bands alias."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsv1_tpu.ops import hzcc as jhz
from dsv1_tpu.ops import sbt as jsbt
from dsv1_tpu_torch.ops import hzcc as thz

torch.set_num_threads(1)


def _case(w, h, is_p, seed):
    rng = np.random.default_rng(seed)
    nbh, nbv = -(-w // 16), -(-h // 16)
    coefs = np.asarray(jsbt.fwd_sbt(jnp.asarray(
        rng.integers(-128, 128, (h, w)).astype(np.int32)), is_p=is_p))
    stable = rng.integers(0, 4, nbh * nbv).astype(np.uint8)
    return coefs, stable, nbh, nbv


@pytest.mark.parametrize("w,h,is_p,plane", [
    (96, 80, False, 0), (96, 80, True, 0), (48, 40, True, 1),
    (100, 84, True, 0),                 # odd ceil dims: aliased bands
    (50, 42, False, 2),
])
@pytest.mark.parametrize("quant", [300, 1540])
def test_encode_plane_core_matches_jax(w, h, is_p, plane, quant):
    coefs, stable, nbh, nbv = _case(w, h, is_p, w * h + quant)
    jt = jhz.build_tables(w, h, nbh, nbv)
    tt = thz.build_tables(w, h, nbh, nbv)
    np.testing.assert_array_equal(tt.perm, jt.perm)
    assert jt.has_overlap or w != 100
    jq, jwb = jhz.encode_plane_core(jnp.asarray(coefs), quant, is_p, plane,
                                    jnp.asarray(stable), jt)
    tq, twb = thz.encode_plane_core(torch.from_numpy(coefs), quant, is_p,
                                    plane, torch.from_numpy(stable), tt)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(twb.numpy(), np.asarray(jwb))
    runs, vals = thz.runs_from_qvals(tq.numpy())
    jruns, jvals = jhz.runs_from_qvals(np.asarray(jq))
    np.testing.assert_array_equal(runs, jruns)
    np.testing.assert_array_equal(vals, jvals)

    # decode side: scatter the quantized values to grid order (last
    # wins over aliased bands) and dequantize
    qgrid = np.zeros(w * h, np.int32)
    qgrid[jt.perm] = np.asarray(jq)
    qgrid = qgrid.reshape(h, w)
    dc = int(coefs[0, 0])
    want = np.asarray(jhz.dequant_plane_grid(jnp.asarray(qgrid), dc, quant,
                                             is_p, plane,
                                             jnp.asarray(stable), jt))
    got = thz.dequant_plane_grid(torch.from_numpy(qgrid), dc, quant, is_p,
                                 plane, torch.from_numpy(stable), tt)
    np.testing.assert_array_equal(got.numpy(), want)
