"""PyTorch port vs JAX: device-side coefficient compaction and the native
chunk packer.

The three compaction functions (ops/hzcc.py) must give the JAX package's
arrays element for element, overflow verdicts included, for each cause
of overflow: too many nonzeros, a zero run past 0xFFFE, a value past
int16, and large values in and beyond the LL segment. The exact
compaction of overflowed chunks must give runs_from_qvals' symbols on
the same planes, whatever overflowed. The bindings
`runs_from_dense8` and `pack_chunk` must give the JAX package's `bits`
output on the same inputs. `encode_stream_gops`, which compacts every
GOP and packs it in one native call, must stay byte-identical to JAX
across the chunk-edge cases of tests/test_chunk_pack.py: a tail GOP,
G = 1, gop 0, and the dense packing when a cap overflows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsv1_tpu import bits as jbits
from dsv1_tpu.constants import (GOP_INTRA, RATE_CONTROL_CRF, SUBSAMP_420,
                                quality_percent)
from dsv1_tpu.models.encoder import EncoderConfig
from dsv1_tpu.models.metadata import Metadata
from dsv1_tpu.ops import hzcc as jhz
from dsv1_tpu.parallel import encode_stream_gops
import dsv1_tpu_torch as dt
from dsv1_tpu_torch import bits as tbits
from dsv1_tpu_torch.ops import hzcc as thz
from dsv1_tpu_torch.parallel.gop import gops_per_chunk
from dsv1_tpu_torch.utils.stats import STATS

from . import corpus

torch.set_num_threads(1)


def _plane(n, density, seed, big=(), amp=200):
    """n int32 quantized values, a share `density` nonzero in [-amp,
    amp), then the (position, value) pairs of `big` written over them."""
    rng = np.random.default_rng(seed)
    q = np.where(rng.random(n) < density, rng.integers(-amp, amp, n), 0)
    q = q.astype(np.int32)
    for pos, val in big:
        q[pos] = val
    return q


SPARSE_CASES = {
    "fits": (5000, 0.01, (), 16, False),
    "count": (5000, 0.5, (), 16, True),          # cnt > K
    "run": (70000, 0.0, ((0, 3), (69000, -2)), 256, True),   # run > 0xFFFE
    "value": (9000, 0.002, ((17, 40000),), 32, True),         # |v| > 0x7FFF
    "run_at_cap": (65536, 0.0, ((65534, 1),), 256, False),  # run 0xFFFE
    "small": (300, 0.3, (), 256, False),       # n < 256: K = n
    "empty": (4096, 0.0, (), 256, False),
}


@pytest.mark.parametrize("case", sorted(SPARSE_CASES))
def test_compact_sparse_p_matches_jax(case):
    n, density, big, cap_div, overflows = SPARSE_CASES[case]
    q = _plane(n, density, n, big)
    want = jhz.compact_sparse_p(jnp.asarray(q), cap_div)
    got = thz.compact_sparse_p(torch.from_numpy(q), cap_div)
    np.testing.assert_array_equal(got[0].numpy().view(np.uint16),
                                  np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int(got[2]) == int(want[2]) == np.count_nonzero(q)
    assert bool(got[3]) == bool(want[3]) == overflows


DENSE_CASES = {
    "fits": (4000, 0.3, 64, (), 0),
    "ll_big": (4000, 0.3, 400, tuple((i, 300 + i) for i in range(0, 60, 3)),
               0),
    "ll_past_k": (4000, 0.0, 400, tuple((i, -500) for i in range(300)),
                  300 - 256),                    # LL big values beyond K
    "hi_big": (4000, 0.1, 64, ((100, 128), (3999, -129), (7, 1000)), 2),
    "ll_one": (500, 0.5, 1, ((0, 2000),), 0),
}


@pytest.mark.parametrize("case", sorted(DENSE_CASES))
def test_compact_dense_i_matches_jax(case):
    n, density, ll_n, big, nbig = DENSE_CASES[case]
    q = _plane(n, density, n + ll_n, big, amp=120)
    want = jhz.compact_dense_i(jnp.asarray(q), ll_n)
    got = thz.compact_dense_i(torch.from_numpy(q), ll_n)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[3]) == nbig
    # the layout's symbols are the plane's, as long as nothing overflowed
    if nbig == 0:
        runs, vals = tbits.runs_from_dense8(*(t.numpy() for t in got[:3]))
        jruns, jvals = thz.runs_from_qvals(q)
        np.testing.assert_array_equal(runs, jruns)
        np.testing.assert_array_equal(vals, jvals)
        wr, wv = jbits.runs_from_dense8(*(np.asarray(t) for t in want[:3]))
        np.testing.assert_array_equal(runs, wr)
        np.testing.assert_array_equal(vals, wv)


EXACT_CASES = ([("sparse", k) for k in sorted(SPARSE_CASES)]
               + [("dense", k) for k in sorted(DENSE_CASES)])


@pytest.mark.parametrize("kind,case", EXACT_CASES)
def test_compact_exact_matches_runs_from_qvals(kind, case):
    """Each case's plane as the one row of the middle of three planes,
    then as the middle row of three planes of two rows (the other rows
    and planes drawn alongside), every cause of overflow among them: too
    many nonzeros, a run past 0xFFFE, a value past int16, |q| > 127
    outside the LL. The JAX package's runs_from_qvals is the oracle."""
    if kind == "sparse":
        n, density, big = SPARSE_CASES[case][:3]
        q = _plane(n, density, n, big)
    else:
        n, density, ll_n, big = DENSE_CASES[case][:4]
        q = _plane(n, density, n + ll_n, big, amp=120)
    others = [_plane(m, 0.05, m + 1, ((m - 1, -70000),)) for m in (77, 5)]
    one = [others[1][None], q[None], others[0][None]]
    two = [np.stack(r) for r in ((others[1], others[1][::-1].copy()),
                                 (q[::-1].copy(), q),
                                 (others[0], others[0] * 0))]
    for ps in (one, two):
        counts = np.array([[np.count_nonzero(r) for r in p] for p in ps])
        buf = thz.compact_exact([torch.from_numpy(p) for p in ps],
                                int(counts.sum()))
        lists = thz.exact_lists(buf.numpy(), counts)
        for p, pl in zip(ps, lists):
            assert len(pl) == len(p)
            for r, (runs, vals) in zip(p, pl):
                want = jhz.runs_from_qvals(r)
                assert runs.dtype == want[0].dtype
                assert vals.dtype == want[1].dtype
                np.testing.assert_array_equal(runs, want[0])
                np.testing.assert_array_equal(vals, want[1])
        # the count the compaction found is checked against the host's
        bad = counts.copy()
        bad.flat[0] += 1
        with pytest.raises(RuntimeError):
            thz.exact_lists(thz.compact_exact(
                [torch.from_numpy(p) for p in ps], int(bad.sum())).numpy(),
                bad)


def test_compact_exact_takes_chunks_past_2_31_positions():
    """A chunk of 180 4K frames (12.44 M positions a frame, 2.24 G in
    all) passes compact_exact's checks: only the symbol count, which the
    int32 buffer holds, is bounded (meta tensors: shapes, no memory)."""
    luma, chroma = 3840 * 2160, 1920 * 1080
    planes = [torch.empty((15, 12, m), dtype=torch.int32, device="meta")
              for m in (luma, chroma, chroma)]
    assert 180 * (luma + 2 * chroma) >= 1 << 31
    assert thz._exact_rows(planes, 300_000 * 180) == (180,
                                                      [luma, chroma, chroma])
    with pytest.raises(ValueError):
        thz._exact_rows(planes, (1 << 31) - 1)
    with pytest.raises(ValueError):
        thz._exact_rows(planes[:2], 0)


@pytest.mark.parametrize("quant", [0, 108, 159, 160, 255, 256, 2047])
def test_sparse_cap_div_matches_jax(quant):
    assert thz.sparse_cap_div(quant) == jhz.sparse_cap_div(quant)


@pytest.mark.parametrize("quant_kind", ["scalar", "per_gop", "per_frame"])
def test_pack_chunk_matches_jax(quant_kind):
    """Two GOPs of three frames, compacted from random planes, the second
    GOP cut after its second frame."""
    rng = np.random.default_rng(5)
    C, G, nbh, nbv = 2, 3, 6, 5
    nblk = nbh * nbv
    sizes = (96 * 80, 48 * 40, 48 * 40)
    iq8, ipos, ivals, pruns, pvals, pcnt = [], [], [], [], [], []
    for c, n in enumerate(sizes):
        comp = [thz.compact_dense_i(torch.from_numpy(
            _plane(n, 0.4, 10 * c + g, ((1, 900),), 100)), 30)
            for g in range(C)]
        iq8.append(np.stack([x[0].numpy() for x in comp]))
        ipos.append(np.stack([x[1].numpy() for x in comp]))
        ivals.append(np.stack([x[2].numpy() for x in comp]))
        comp = [[thz.compact_sparse_p(torch.from_numpy(
            _plane(n, 0.02, 100 * c + 10 * g + i)), 16) for i in range(G - 1)]
            for g in range(C)]
        pruns.append(np.stack([[x[0].numpy().view(np.uint16) for x in r]
                               for r in comp]))
        pvals.append(np.stack([[x[1].numpy() for x in r] for r in comp]))
        pcnt.append(np.stack([[int(x[2]) for x in r] for r in comp])
                    .astype(np.int32))
    quant = {"scalar": 700, "per_gop": np.array([[300, 500], [310, 520]]),
             "per_frame": rng.integers(100, 1500, (C, G))}[quant_kind]
    meta = b"DSV1\x00" + bytes(range(20))
    args = (b"DSV1", 0, 16, 16, nbh, nbv, quant, 11, meta, C, G, 4, 6, 17,
            0, 1, iq8, ipos, ivals, rng.integers(-900, 900, (C, 3)),
            rng.integers(0, 4, (C, nblk)).astype(np.uint8), pruns, pvals,
            pcnt, rng.integers(-900, 900, (C, G - 1, 3)),
            np.array([[1, 0], [1, 1]], np.uint8),
            rng.integers(0, 2, (C, G - 1, nblk)).astype(np.uint8),
            rng.integers(-60, 60, (C, G - 1, nblk)).astype(np.int16),
            rng.integers(-60, 60, (C, G - 1, nblk)).astype(np.int16),
            rng.integers(0, 16, (C, G - 1, nblk)).astype(np.uint8),
            rng.integers(0, 4, (C, G - 1, nblk)).astype(np.uint8), 1234)
    got, link = tbits.pack_chunk(*args)
    want, want_link = jbits.pack_chunk(*args)
    assert got == want and link == want_link
    assert got.count(meta) == 2 and len(got) > 2 * len(meta)


W, H = 96, 64


def _check_stream(frames, cfg_kw):
    meta = Metadata(W, H, SUBSAMP_420)
    want = encode_stream_gops(frames, meta,
                              EncoderConfig(rc_mode=RATE_CONTROL_CRF,
                                            **cfg_kw))
    STATS.clear()
    got = dt.encode_stream_gops(frames, dt.Metadata(W, H, dt.SUBSAMP_420),
                                dt.EncoderConfig(**cfg_kw), device="cpu")
    assert got == want
    return dict(STATS)


@pytest.mark.parametrize("gop,n", [(4, 13), (1, 5), (4, 4), (GOP_INTRA, 7)])
def test_chunk_edges_match_jax(gop, n):
    """A tail GOP of one frame, G = 1, one whole GOP, and gop 0 (chunks of
    intra frames, one pack_chunk call each)."""
    frames = corpus.make_clip_frames(W, H, SUBSAMP_420, n, seed=3)
    cfg_kw = dict(quality=quality_percent(85), gop=gop,
                  stable_refresh=max(1, gop - 1))
    stats = _check_stream(frames, cfg_kw)
    # through the core: every frame, the tail padded to a whole chunk of
    # GOPs as the JAX package pads it (gop 0 pads nothing)
    span = 1 if gop == GOP_INTRA else gop * gops_per_chunk(
        dt.EncoderConfig(**cfg_kw), W, H, n)
    assert stats["core_i"] + stats.get("core_p", 0) == -(-n // span) * span
    assert not stats.get("overflow_redos")


def test_dense_packing_on_overflow_matches_jax():
    """A mid-GOP cut to noise at quality 95 %: the forced-intra P slot's
    dense planes overflow the sparse cap, so the GOP is packed from its
    dense planes, and the bytes stay JAX's."""
    rng = np.random.default_rng(11)
    flat = [(np.full((H, W), 60, np.uint8),
             np.full((H // 2, W // 2), 128, np.uint8),
             np.full((H // 2, W // 2), 128, np.uint8)) for _ in range(2)]
    noisy = [(rng.integers(0, 256, (H, W), dtype=np.uint8),
              rng.integers(0, 256, (H // 2, W // 2), dtype=np.uint8),
              rng.integers(0, 256, (H // 2, W // 2), dtype=np.uint8))
             for _ in range(2)]
    stats = _check_stream(flat + noisy, dict(quality=quality_percent(95),
                                             gop=4, stable_refresh=3))
    assert stats["overflow_redos"] == 1
    assert stats["overflow_syms"] > 0


def _checker(n):
    """n frames of a one-pixel luma checkerboard, its phase flipping each
    frame, on flat chroma: at quality 100 % the I planes' finest bands
    hold values past int8, so the I cap overflows and the P cap does
    not."""
    yx = np.indices((H, W)).sum(0)
    return [(((yx + k) % 2 * 255).astype(np.uint8),
             np.full((H // 2, W // 2), 128, np.uint8),
             np.full((H // 2, W // 2), 128, np.uint8)) for k in range(n)]


def _noise(n):
    rng = np.random.default_rng(11)
    return [(rng.integers(0, 256, (H, W), dtype=np.uint8),
             rng.integers(0, 256, (H // 2, W // 2), dtype=np.uint8),
             rng.integers(0, 256, (H // 2, W // 2), dtype=np.uint8))
            for _ in range(n)]


@pytest.mark.parametrize("clip,caps", [("checker", "i"), ("noise", "ip")])
def test_exact_route_on_i_cap_overflow_matches_jax(clip, caps):
    """Chunks whose I cap overflows (alone, and with the P cap) are packed
    from the exact compaction's lists, and the bytes stay JAX's."""
    frames = {"checker": _checker, "noise": _noise}[clip](4)
    stats = _check_stream(frames, dict(quality=quality_percent(100), gop=4,
                                       stable_refresh=3))
    assert stats["overflow_redos"] == stats["overflow_exact"] == 1
    assert stats["overflow_i"] >= 1 and stats["overflow_syms"] > 0
    assert bool(stats.get("overflow_p")) == ("p" in caps)
