"""PyTorch port vs JAX: forward and inverse subband transforms, intra (B4T
level 1, even dims) and inter (Haar), luma (filtered inverse) and chroma,
even and odd sizes; and the port's Haar level (`haar_fwd_level`, the
plain version of csrc/sbt.cu) against the Pallas Haar kernel of
tools/bench_haar.py in interpret mode and its `fwd_v4`. Integer-exact:
compared with assert_array_equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

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
    (54, 38, False), (102, 70, False),  # intra: odd regions from level 2
    (37, 23, True), (1, 5, True),       # odd P planes, a 1-wide column
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


def _pallas_haar_level(a, TH=8, TW=512):
    """One scaled Haar level by the Pallas kernel of tools/bench_haar.py
    (its body copied from there), in interpret mode: (LL, LH, HL, HH)."""
    def kern(x_ref, ll_ref, lh_ref, hl_ref, hh_ref):
        x = x_ref[...]
        r = x.reshape(TH // 2, 2, TW)
        s = r[:, 0, :] + r[:, 1, :]
        d = r[:, 0, :] - r[:, 1, :]
        s2 = s.reshape(TH // 2, TW // 2, 2)
        d2 = d.reshape(TH // 2, TW // 2, 2)
        su, sv = s2[:, :, 0], s2[:, :, 1]
        du, dv = d2[:, :, 0], d2[:, :, 1]
        ll = (su + sv) * 4
        ll_ref[...] = jax.lax.div(ll, 5)
        lh_ref[...] = su - sv
        hl_ref[...] = du + dv
        hh_ref[...] = du - dv

    H, W = a.shape
    qshape = jax.ShapeDtypeStruct((H // 2, W // 2), jnp.int32)
    return pl.pallas_call(
        kern, grid=(H // TH, W // TW),
        in_specs=[pl.BlockSpec((TH, TW), lambda i, j: (i, j))],
        out_specs=[pl.BlockSpec((TH // 2, TW // 2), lambda i, j: (i, j))] * 4,
        out_shape=[qshape] * 4, interpret=True)(jnp.asarray(a))


def _port_level(a, scale_ll=True):
    """The port's plain Haar level: (LL, LH, HL, HH) numpy arrays."""
    H, W = a.shape
    out = torch.zeros((H, W), dtype=torch.int32)
    ll = tsbt.haar_fwd_level(torch.from_numpy(a), out, scale_ll).numpy()
    o = out.numpy()
    ch, cw = (H + 1) // 2, (W + 1) // 2
    return ll, o[:ch, cw:], o[ch:, :cw], o[ch:, cw:]


def test_haar_level_plain_matches_pallas_kernel():
    a = np.random.default_rng(5).integers(-5000, 5000, (16, 1024)) \
        .astype(np.int32)
    for name, g, e in zip(("LL", "LH", "HL", "HH"), _port_level(a),
                          _pallas_haar_level(a)):
        np.testing.assert_array_equal(g, np.asarray(e), err_msg=name)


def test_haar_level_plain_matches_bench_fwd_v4():
    """The 1080p luma level 1 shape of tools/bench_haar.py, assembled."""
    cache = jax.config.jax_compilation_cache_dir
    try:
        from tools import bench_haar   # sets its own compile-cache dir
    finally:
        jax.config.update("jax_compilation_cache_dir", cache)
    a = np.random.default_rng(6).integers(-256, 256, (1080, 1920)) \
        .astype(np.int32)
    ll, lh, hl, hh = _port_level(a)
    got = np.block([[ll, lh], [hl, hh]])
    np.testing.assert_array_equal(got, np.asarray(
        jax.jit(bench_haar.fwd_v4)(jnp.asarray(a))))


@pytest.mark.parametrize("h,w", [(9, 7), (1, 6), (5, 1)])
def test_haar_level_odd_region_in_assembled_array(h, w):
    """An odd region inside a larger array: the bands land in their
    rectangles, nothing outside the region is written, LL is returned."""
    rng = np.random.default_rng(h * w)
    a = rng.integers(-999, 999, (h, w)).astype(np.int32)
    out = torch.full((h + 3, w + 2), 7777, dtype=torch.int32)
    ll = tsbt.haar_fwd_level(torch.from_numpy(a), out, False).numpy()
    L = tsbt._haar_fwd_region(torch.from_numpy(a), False)
    ch, cw, fh, fw = (h + 1) // 2, (w + 1) // 2, h // 2, w // 2
    o = out.numpy()
    np.testing.assert_array_equal(ll, L[0].numpy())
    np.testing.assert_array_equal(o[:ch, cw:cw + fw], L[1].numpy())
    np.testing.assert_array_equal(o[ch:ch + fh, :cw], L[2].numpy())
    np.testing.assert_array_equal(o[ch:ch + fh, cw:cw + fw], L[3].numpy())
    assert (o[:ch, :cw] == 7777).all()          # LL corner left alone
    assert (o[h:] == 7777).all() and (o[:, w:] == 7777).all()
