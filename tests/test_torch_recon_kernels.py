"""PyTorch port vs JAX: the recon chain's per-frame step that the port runs
on its recon kernels (csrc/recon.cu, csrc/hzcc.cu), through their plain
versions on the CPU.

- The prologue (`bmc.residual_in`: subf, the centring and the border
  column of every plane of a batch of frames) then `sbt.fwd_sbt`, against
  the JAX core's sub_residual - 128 + fwd_sbt; the recon
  (`sbt.inv_sbt_recon`: inv_sbt, sbc2int, addf, the plane written into
  the frame image) against inv_sbt + coefs_to_plane + add_residual +
  image_from_planes, with a quant per frame of the batch.
- A numpy model of the HZCC kernels' per-position chain (each position
  walks the segments that contain it in traversal order, carrying its
  write-back; the decoder's last segment wins) against the JAX
  package's encode_plane_core and dequant_plane_grid, over geometries
  whose bands alias.
- The intra level-1 B4T (`sbt.b4t_fwd`) and its LL copy, the inverse's
  launch plan (`sbt.inv_plan`: every level once, the coarse stage's
  shared memory within a block's), the coarse stage's quad rows by a
  multiply-high (exact), the quantizer kernel's
  multiply-high reciprocals (a numpy mirror, exact on every step of the
  quant law), and the CPU route's launch counts (none).

Integer-exact: compared with assert_array_equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dsv1_tpu_torch as dt
from dsv1_tpu.ops import bmc as jbmc
from dsv1_tpu.ops import frame as jfr
from dsv1_tpu.ops import hzcc as jhz
from dsv1_tpu.ops import sbt as jsbt
from dsv1_tpu_torch.kernels.build import LAUNCHES
from dsv1_tpu_torch.models.encoder import block_geometry, coef_geometry
from dsv1_tpu_torch.ops import bmc as tbmc
from dsv1_tpu_torch.ops import frame as tfr
from dsv1_tpu_torch.ops import hzcc as thz
from dsv1_tpu_torch.ops import sbt as tsbt

torch.set_num_threads(1)

QUANTS = [85, 600, 1540]     # one per frame of the batch (C = 3)
GEOMETRIES = [(96, 80), (100, 84)]
SUBSAMPS = [dt.SUBSAMP_420, dt.SUBSAMP_422]
# the segment table of csrc/hzcc.cu holds at most this many segments
KERNEL_MAX_SEGS = 10


def _batch(w, h, subsamp, seed):
    """(layout, coef dims, traversal tables, planes (3 lists of C (h, w)
    u8 arrays), predictions alike)."""
    rng = np.random.default_rng(seed)
    _bw, _bh, nbh, nbv = block_geometry(w, h)
    layout, dims, tables = coef_geometry(subsamp, w, h, nbh, nbv)

    def planes():
        return [rng.integers(0, 256, (len(QUANTS), p.h, p.w))
                .astype(np.uint8) for p in layout.planes]
    return layout, dims, tables, planes(), planes()


def _torch_preds(layout, preds):
    """The predictions as compensate_frame gives them: (C, h, w) views of
    one (C, sum h * w) buffer."""
    C = preds[0].shape[0]
    flat = torch.from_numpy(np.concatenate([p.reshape(C, -1)
                                            for p in preds], -1))
    out, off = [], 0
    for p in layout.planes:
        out.append(flat[:, off:off + p.h * p.w].unflatten(-1, (p.h, p.w)))
        off += p.h * p.w
    return tuple(out)


@pytest.mark.parametrize("w,h", GEOMETRIES)
@pytest.mark.parametrize("subsamp", SUBSAMPS)
@pytest.mark.parametrize("is_p", [False, True])
def test_prologue_then_fwd_sbt_matches_jax(w, h, subsamp, is_p):
    layout, dims, _t, planes, preds = _batch(w, h, subsamp, w + subsamp)
    img = tfr.image_from_planes(layout, [torch.from_numpy(p)
                                         for p in planes])
    got = tbmc.residual_in(img, layout, dims,
                           _torch_preds(layout, preds) if is_p else None)
    jlay = jfr.make_layout(subsamp, w, h, True)
    for b in range(len(QUANTS)):
        jimg = jfr.image_from_planes(jlay, [jnp.asarray(p[b])
                                            for p in planes])
        np.testing.assert_array_equal(img[b].numpy(), np.asarray(jimg))
        for c in range(3):
            p = jlay.planes[c]
            cw, ch = dims[c]
            src_ext = jfr.plane_view_ext(jimg, jlay, c, cw - p.w)
            core = src_ext[:p.h, :p.w]
            if is_p:
                core = jbmc.sub_residual(core, jnp.asarray(preds[c][b]))
            coefs = jnp.zeros((ch, cw), jnp.int32)
            coefs = coefs.at[:p.h, :p.w].set(core.astype(jnp.int32) - 128)
            if cw > p.w:
                coefs = coefs.at[:p.h, p.w:cw].set(
                    src_ext[:p.h, p.w:cw].astype(jnp.int32) - 128)
            np.testing.assert_array_equal(got[c][b].numpy(),
                                          np.asarray(coefs))
            np.testing.assert_array_equal(
                tsbt.fwd_sbt(got[c][b], is_p).numpy(),
                np.asarray(jsbt.fwd_sbt(coefs, is_p=is_p)))


@pytest.mark.parametrize("w,h", GEOMETRIES)
@pytest.mark.parametrize("subsamp", SUBSAMPS)
@pytest.mark.parametrize("is_p", [False, True])
def test_recon_epilogue_matches_jax(w, h, subsamp, is_p):
    layout, dims, _t, _planes, preds = _batch(w, h, subsamp, 3 * w + h)
    rng = np.random.default_rng(w * h + is_p)
    C = len(QUANTS)
    tpreds = _torch_preds(layout, preds)
    img = torch.zeros((C, layout.total + 2 * layout.margin),
                      dtype=torch.uint8)
    wbs = []
    for c, (cw, ch) in enumerate(dims):
        # written-back coefficients with a sparse, quantised-looking spread
        a = np.stack([np.asarray(jsbt.fwd_sbt(jnp.asarray(
            rng.integers(-128, 128, (ch, cw)).astype(np.int32)),
            is_p=is_p)) for _ in range(C)])
        a = np.where(rng.random(a.shape) < 0.3, a, 0).astype(np.int32)
        wbs.append(a)
        tsbt.inv_sbt_recon(torch.from_numpy(a),
                           torch.tensor(QUANTS, dtype=torch.int32), is_p,
                           c == 0, img, layout, c,
                           tpreds[c] if is_p else None)
    jlay = jfr.make_layout(subsamp, w, h, True)
    for b, q in enumerate(QUANTS):
        rec = []
        for c in range(3):
            p = jlay.planes[c]
            r = jsbt.inv_sbt(jnp.asarray(wbs[c][b]), q, is_p=is_p,
                             is_luma=(c == 0))
            rp = jsbt.coefs_to_plane(r)[:p.h, :p.w]
            if is_p:
                rp = jbmc.add_residual(jnp.asarray(preds[c][b]), rp)
            rec.append(rp)
        np.testing.assert_array_equal(
            img[b].numpy(), np.asarray(jfr.image_from_planes(jlay, rec)))


# --- a numpy model of csrc/hzcc.cu: one chain per grid position ---------

def _cdiv(a, b):
    """C's truncating division of non-negative int64 arrays."""
    return a // b


def _frame_quants(q, is_p, plane):
    def gq(q, level):
        if is_p:
            q = q * 3 // 2
        if level == 1:
            q = q * 2 // 3
        elif level == 2:
            q = q * 3 // 2
        return max(q, 16)
    if plane > 0:
        q = min(q, 512)
    def lb2(n):
        k = 0
        while (1 << k) < n:
            k += 1
        return k
    ll, q1, q2 = gq(q, 0), gq(q, 1), lb2(gq(q, 2))
    return ll, q1, q2, min(max(q2 - (1 if is_p else 3), 1), 24)


def _seg_params(seg, ly, lx, Q, stable2d, nbh, nbv):
    """(param, is_hi) arrays of segment `seg` at local positions."""
    lvl, _oy, _ox, sh, sw = seg
    ll, q1, q2, q2h = Q
    if lvl < 0:
        return np.full(ly.shape, ll, np.int64), False
    bi = (lx * ((nbh << 14) // sw)) >> 14
    bj = (ly * ((nbv << 14) // sh)) >> 14
    st = stable2d[bj, bi]
    if lvl == 2:
        return np.where(st != 0, q2h, q2).astype(np.int64), True
    qp = ll if lvl == 0 else q1
    t = np.where(st & 2, qp >> 2, np.where(st != 0, qp >> 1, qp))
    return np.maximum(t, 16).astype(np.int64), False


def _segs(tables):
    return [(lvl, oy, ox, sh, sw)
            for (lvl, oy, ox, sh, sw, _bj, _bi) in tables.segs]


def model_quant(coefs, q, is_p, plane, stable, tables):
    """The kernel's algorithm: every position (y, x) carries its value
    through the segments containing it, in traversal order."""
    H, W = coefs.shape
    ys, xs = np.divmod(np.arange(H * W), W)
    v = coefs.reshape(-1).astype(np.int64).copy()
    v[0] = 0
    Q = _frame_quants(q, is_p, plane)
    st2 = stable.reshape(tables.nbv, tables.nbh).astype(np.int64)
    qvals = np.zeros(tables.n, np.int64)
    off = 0
    for seg in _segs(tables):
        _lvl, oy, ox, sh, sw = seg
        pos = np.flatnonzero((ys >= oy) & (ys < oy + sh) & (xs >= ox)
                             & (xs < ox + sw))
        ly, lx = ys[pos] - oy, xs[pos] - ox
        p, hi = _seg_params(seg, ly, lx, Q, st2, tables.nbh, tables.nbv)
        x = v[pos]
        if hi:
            qv = np.sign(x) * (np.abs(x) >> p)
            wb = qv << p
        else:
            a = np.abs(x) << 1
            qv = np.where(a <= p, 0, np.sign(x) * _cdiv(a + 1, p << 1))
            wb = np.sign(qv) * ((np.abs(qv) * (p << 1) + p) >> 1)
        qvals[off + ly * sw + lx] = qv
        v[pos] = np.where(qv == 0, 0, wb)
        off += sh * sw
    v[0] = coefs[0, 0]
    return qvals.astype(np.int32), v.reshape(H, W).astype(np.int32)


def model_dequant(qgrid, dc, q, is_p, plane, stable, tables):
    """Every position dequantizes its grid value for each segment that
    contains it: the last one wins."""
    H, W = qgrid.shape
    ys, xs = np.divmod(np.arange(H * W), W)
    g = qgrid.reshape(-1).astype(np.int64)
    out = np.zeros(H * W, np.int64)
    Q = _frame_quants(q, is_p, plane)
    st2 = stable.reshape(tables.nbv, tables.nbh).astype(np.int64)
    for seg in _segs(tables):
        _lvl, oy, ox, sh, sw = seg
        pos = np.flatnonzero((ys >= oy) & (ys < oy + sh) & (xs >= ox)
                             & (xs < ox + sw))
        p, hi = _seg_params(seg, ys[pos] - oy, xs[pos] - ox, Q, st2,
                            tables.nbh, tables.nbv)
        x = g[pos]
        dq = (x << p) if hi else np.sign(x) * ((np.abs(x) * (p << 1) + p)
                                               >> 1)
        out[pos] = np.where(x == 0, 0, dq)
    out[0] = dc
    return out.reshape(H, W).astype(np.int32)


@pytest.mark.parametrize("w,h,nbh,nbv", [
    (96, 80, 6, 5), (100, 84, 7, 6), (50, 42, 4, 3), (102, 70, 7, 5),
    (130, 62, 9, 4), (66, 34, 5, 3),
])
@pytest.mark.parametrize("is_p,plane,quant", [
    (False, 0, 300), (True, 1, 1540), (True, 0, 85),
])
def test_hzcc_kernel_model_matches_jax(w, h, nbh, nbv, is_p, plane, quant):
    rng = np.random.default_rng(w * h + quant)
    coefs = np.array(jsbt.fwd_sbt(jnp.asarray(
        rng.integers(-128, 128, (h, w)).astype(np.int32)), is_p=is_p))
    coefs[rng.random(coefs.shape) < 0.05] *= 40   # far past the steps
    stable = rng.integers(0, 4, nbh * nbv).astype(np.uint8)
    jt = jhz.build_tables(w, h, nbh, nbv)
    tt = thz.build_tables(w, h, nbh, nbv)
    # each position lies in at most as many segments as the kernel's
    # table holds; where bands alias, in more than one
    cover = np.bincount(tt.perm, minlength=w * h)
    assert len(tt.segs) <= KERNEL_MAX_SEGS
    assert cover.max() <= len(tt.segs)
    assert (cover.max() > 1) == jt.has_overlap
    jq, jwb = jhz.encode_plane_core(jnp.asarray(coefs), quant, is_p, plane,
                                    jnp.asarray(stable), jt)
    mq, mwb = model_quant(coefs, quant, is_p, plane, stable, tt)
    np.testing.assert_array_equal(mq, np.asarray(jq))
    np.testing.assert_array_equal(mwb, np.asarray(jwb))
    qgrid = np.zeros(w * h, np.int32)
    qgrid[jt.perm] = np.asarray(jq)     # the parser's last-wins scatter
    qgrid = qgrid.reshape(h, w)
    dc = int(coefs[0, 0])
    want = np.asarray(jhz.dequant_plane_grid(jnp.asarray(qgrid), dc, quant,
                                             is_p, plane,
                                             jnp.asarray(stable), jt))
    np.testing.assert_array_equal(
        model_dequant(qgrid, dc, quant, is_p, plane, stable, tt), want)


def test_hzcc_geometries_alias():
    """The sweep above holds aliasing geometries (odd ceil dims)."""
    assert thz.build_tables(100, 84, 7, 6).n > 100 * 84
    assert jhz.build_tables(100, 84, 7, 6).has_overlap
    assert not jhz.build_tables(96, 80, 6, 5).has_overlap


@pytest.mark.parametrize("w,h", [(96, 80), (50, 42), (2, 2)])
def test_b4t_fwd_matches_jax(w, h):
    a = np.random.default_rng(w).integers(-128, 128, (2, h, w)) \
        .astype(np.int32)
    out, ll = tsbt.b4t_fwd(torch.from_numpy(a))
    for b in range(2):
        want = np.asarray(jsbt._b4t_fwd_2d(jnp.asarray(a[b])))
        np.testing.assert_array_equal(out[b].numpy(), want)
        np.testing.assert_array_equal(ll[b].numpy(),
                                      want[:h // 2, :w // 2])
    with pytest.raises(ValueError):
        tsbt.b4t_fwd(torch.zeros((4, 5), dtype=torch.int32))


def test_inv_plan():
    """The inverse's split: the coarse stage runs top..lo in one block per
    plane, as deep as its staged corner fits `INV_COARSE_BYTES` (never
    below level 3), then levels lo - 1..3 two a launch, then levels 2 and
    1 in one launch (1 launch for a plane of one or two levels)."""
    for W, H in ((1920, 1080), (960, 540), (3840, 2160), (352, 288),
                 (48, 40), (100, 84), (2, 2), (4, 4), (1, 300)):
        top, lo, n = tsbt.inv_plan(W, H)
        assert top == tsbt.nlevels(W, H)
        if top < 3:
            assert (lo, n) == (top + 1, 1)
            continue
        assert 3 <= lo <= top and n == 2 + (lo - 3 + 1) // 2

        def out(i):
            return tsbt.round_shift(H, i - 1) * tsbt.round_shift(W, i - 1)
        assert lo == top or 4 * out(lo) <= tsbt.INV_COARSE_BYTES
        assert lo == 3 or 4 * out(lo - 1) > tsbt.INV_COARSE_BYTES
    assert tsbt.inv_plan(1920, 1080) == (11, 5, 3)
    assert tsbt.inv_plan(3840, 2160) == (12, 6, 4)
    assert tsbt.inv_plan(352, 288) == (9, 3, 2)
    # launches a frame, 4:2:0: 1080p 3 + 3 + 3 (13 before), 4K 4 + 3 + 3
    # (16), CIF 2 + 2 + 2 (7)
    for (w, h), n in (((1920, 1080), 9), ((3840, 2160), 10),
                      ((352, 288), 6)):
        assert sum(tsbt.inv_plan(pw, ph)[2] for pw, ph in
                   ((w, h), (w // 2, h // 2), (w // 2, h // 2))) == n


# the planes of the smoke run's recon cases: CIF, 1080p and 4K luma and
# 4:2:0 chroma, the odd geometries, 4:2:2 and 4:1:1 chroma at 1080p, the
# largest coarse stage (1776x1760 and its chroma)
STAGE_PLANES = [(352, 288), (176, 144), (1920, 1080), (960, 540),
                (3840, 2160), (100, 84), (50, 42), (98, 82), (960, 1080),
                (480, 1080), (102, 86), (52, 44), (1918, 1078), (960, 540),
                (1776, 1760), (888, 880)]


@pytest.mark.parametrize("W,H", sorted(set(STAGE_PLANES)))
def test_inv_stages_cover_levels_and_fit(W, H):
    """The launches of `inv_plan` run every level exactly once, top to 1:
    the coarse stage top..lo, then pairs down to 3 (the last alone where
    their count is odd), then levels 2 and 1; the coarse stage's dynamic
    shared memory (its corner, level lo's input, and two buffers of level
    lo's LL) fits a block (232,448 bytes on sm_90; the tile kernels'
    static shared memory is nvcc's to check); the scratch holds level 3's
    output once, twice where launches between the coarse stage and the
    last write it in turns."""
    top, lo, n = tsbt.inv_plan(W, H)
    if top < 3:
        stages = [tuple(range(top, 0, -1))]
    else:
        stages = [tuple(range(top, lo - 1, -1))]
        i = lo - 1
        while i >= 3:
            stages.append((i, i - 1) if i - 1 >= 3 else (i,))
            i -= len(stages[-1])
        stages.append((2, 1))
        hs, ws = tsbt.round_shift(H, lo - 1), tsbt.round_shift(W, lo - 1)
        assert 4 * (hs + 2 * ((hs + 1) // 2)) * ws <= 232448
    assert [i for lv in stages for i in lv] == list(range(top, 0, -1))
    assert len(stages) == n
    n3 = tsbt.round_shift(H, 2) * tsbt.round_shift(W, 2)
    assert tsbt.inv_scratch(W, H) == (0 if top < 3 else
                                      n3 * (2 if lo > 3 else 1))


def test_coarse_quad_row_exact():
    """The coarse stage's quad rows without a division (csrc/recon.cu
    `quad_rcp`, `quad_row`: umulhi(p, floor((2^32 - 1) / cw) + 1), p
    itself for cw = 1) equal p // cw for every level width a coarse stage
    can hold (its levels fit 232,448 bytes: at most 58,112 values) and
    every quad index of such a level."""
    rng = np.random.default_rng(3)
    for cw in list(range(1, 1025)) + [2047, 4096, 29056, 58112]:
        m = np.uint64((0xFFFFFFFF // cw + 1) & 0xFFFFFFFF)
        n = 58112 // 4 if cw <= 58112 // 4 else cw
        p = np.unique(np.concatenate([
            np.arange(min(n, 3 * cw + 2)), [n - 1, cw - 1, cw, cw + 1],
            rng.integers(0, n, 200)])).astype(np.uint64)
        p = p[p < n]
        got = p if cw == 1 else (p * m) >> np.uint64(32)
        np.testing.assert_array_equal(got, p // np.uint64(cw))


# --- the quantizer's reciprocals (csrc/hzcc.cu `make_div`, `div_by`) ----

def _make_div(d: int):
    """The kernel's (m, s) for a divisor d >= 2: l = ceil(log2 d), m =
    floor(2^(31 + l) / d) + 1, s = l - 1."""
    ln = (d - 1).bit_length()
    return (1 << (31 + ln)) // d + 1, ln - 1


def _div_by(n, m: int, s: int):
    """umulhi(n, m) >> s of uint32 n (numpy)."""
    return ((n.astype(np.uint64) * np.uint64(m)) >> np.uint64(32)) \
        >> np.uint64(s)


def _law_steps(is_p: bool, plane: int):
    """Every lower-frequency step the quant law gives one kind of plane:
    qualities 0..2047 through quant_of_quality, qp_ll and tmq4pos of qp0
    and qp1 at stability flags 0..3."""
    qs = dt.constants.quant_of_quality(np.arange(dt.MAX_QUALITY + 1))
    st = torch.arange(4, dtype=torch.int32)
    steps = set()
    for q in np.unique(qs):
        qp_ll, qp0, qp1, _q2, _q2h = thz.frame_quants(int(q), is_p, plane)
        steps.add(int(qp_ll))
        for qp in (qp0, qp1):
            steps.update(int(t) for t in thz.tmq4pos(qp, st))
    return sorted(steps)


@pytest.mark.parametrize("is_p", [False, True])
@pytest.mark.parametrize("plane", [0, 1])
def test_quant_reciprocal_exact(is_p, plane):
    """The kernel's multiply-high reciprocal of every divisor 2 q the
    quantizer meets gives C's floor division on 0, d - 1, d, k d - 1 and
    k d up to the range and the range's maximum 2^31 - 1 (the quantizer
    divides 2 |v| + 1 < 2^31)."""
    steps = _law_steps(is_p, plane)
    assert min(steps) >= dt.constants.MINQUANT
    top = 2**31 - 1
    for q in steps:
        d = 2 * q
        m, s = _make_div(d)
        assert 2**31 <= m < 2**32 and s >= 0
        ks = np.unique(np.geomspace(1, top // d, 48).astype(np.int64))
        n = np.concatenate([[0, 1, d - 1, d, d + 1, top, top - 1],
                            ks * d - 1, ks * d, ks * d + 1,
                            [(top // d) * d, (top // d) * d - 1]])
        n = n[(n >= 0) & (n <= top)].astype(np.int64)
        np.testing.assert_array_equal(_div_by(n, m, s).astype(np.int64),
                                      n // d)


def test_quant_dividends_in_range():
    """fwd_sbt of the most extreme u8 residuals at the largest geometry
    the smoke run codes (3840x2160: 12 levels) keeps 2 |v| + 1 below
    2^31, the reciprocals' range."""
    for v in (-128, 127):
        for is_p in (False, True):
            c = tsbt.fwd_sbt(torch.full((2160, 3840), v, dtype=torch.int32),
                             is_p)
            assert 2 * int(c.abs().max()) + 1 < 2**31


def test_cpu_route_launches_nothing():
    """On CPU tensors every recon wrapper runs its plain version: the
    launch counts stay 0."""
    LAUNCHES.clear()
    layout, dims, tables, planes, preds = _batch(96, 80, dt.SUBSAMP_420, 1)
    img = tfr.image_from_planes(layout, [torch.from_numpy(p)
                                         for p in planes])
    tp = _torch_preds(layout, preds)
    stable = torch.zeros((len(QUANTS), tables[0].nbh * tables[0].nbv),
                         dtype=torch.uint8)
    q = torch.tensor(QUANTS, dtype=torch.int32)
    rec = torch.zeros_like(img)
    for is_p in (False, True):
        cs = tbmc.residual_in(img, layout, dims, tp if is_p else None)
        for c in range(3):
            coefs = tsbt.fwd_sbt(cs[c], is_p)
            qv, wb = thz.encode_plane_core(coefs, q, is_p, c, stable,
                                           tables[c])
            thz.dequant_plane_grid(wb, coefs[:, 0, 0], q, is_p, c, stable,
                                   tables[c])
            tsbt.inv_sbt(wb, q, is_p, c == 0)
            tsbt.inv_sbt_recon(wb, q, is_p, c == 0, rec, layout, c,
                               tp[c] if is_p else None)
    assert sum(LAUNCHES.values()) == 0
