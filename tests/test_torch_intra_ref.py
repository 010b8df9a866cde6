"""The port's intra-only encode (gop 0 under CRF, parallel/gop.py
`_encode_intra`) against the benchmark's plain reference for it
(benchmark/reference/dsvintra), byte for byte, on the CPU: on the
compacted route, on the route that reads an overflowed chunk back dense,
and at a size that is no multiple of the block size; with the path's
spans and counters (`gop.intra_core`, `gop.intra_compact`,
`gop.intra_scan`, `intra_chunks`, `intra_dense_bytes`)."""

import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import dsv1_tpu_torch as dt
from dsv1_tpu_torch.models.encoder import block_geometry, coef_geometry
from dsv1_tpu_torch.utils.corpus import make_rich_clip, split_frames
from dsv1_tpu_torch.utils.stats import STATS

REFERENCE = Path(__file__).resolve().parent.parent / "benchmark" / "reference"
if str(REFERENCE) not in sys.path:
    sys.path.insert(0, str(REFERENCE))

import dsvintra  # noqa: E402

torch.set_num_threads(1)

# (width, height, frames, quality %, whether the I cap overflows)
CASES = {"cif_q85": (352, 288, 3, 85, False),
         "cif_q100_dense": (352, 288, 3, 100, True),
         "200x120_q85": (200, 120, 4, 85, False),
         "200x120_q100_dense": (200, 120, 2, 100, True)}


def _frames(w, h, n, seed=2**33 + 17):
    return split_frames(make_rich_clip(w, h, dt.SUBSAMP_420, n, seed=seed),
                        w, h, dt.SUBSAMP_420, n)


def _port(frames, w, h, q):
    STATS.clear()
    return dt.encode_stream_gops(
        frames, dt.Metadata(w, h, dt.SUBSAMP_420),
        dt.EncoderConfig(quality=dt.quality_percent(q), gop=0), "cpu")


def _ref(frames, w, h, q):
    return dsvintra.encode_stream_gops(
        frames, dsvintra.Metadata(w, h, dt.SUBSAMP_420),
        dsvintra.EncoderConfig(quality=dsvintra.quality_percent(q), gop=0),
        "cpu")


@pytest.mark.parametrize("case", list(CASES))
def test_intra_encode_matches_the_plain_reference(case):
    w, h, n, q, dense = CASES[case]
    frames = _frames(w, h, n)
    got = _port(frames, w, h, q)
    st = dict(STATS)
    assert got == _ref(frames, w, h, q)
    # CIF and 200x120 frames fit one chunk of the intra path
    assert st["intra_chunks"] == 1
    assert st["core_i"] == n and st["core_calls_recon"] == 0
    assert "chunks" not in st
    assert (st.get("overflow_redos", 0) > 0) == dense
    assert st["overflow_i"] == st.get("overflow_redos", 0)
    if dense:
        # every value of every plane as int32, counted in d2h_bytes too
        tables = coef_geometry(dt.SUBSAMP_420, w, h,
                               *block_geometry(w, h)[2:])[2]
        n_vals = sum(t.n for t in tables)
        assert st["intra_dense_bytes"] == 4 * n * n_vals
        assert st["intra_dense_bytes"] < st["d2h_bytes"]
    else:
        assert "intra_dense_bytes" not in st


@pytest.mark.parametrize("at", ["first", "middle", "last"])
def test_a_flipped_byte_of_the_reference_is_told_apart(at):
    w, h, n, q, _ = CASES["200x120_q85"]
    frames = _frames(w, h, n)
    want = _ref(frames, w, h, q)
    i = {"first": 0, "middle": len(want) // 2, "last": len(want) - 1}[at]
    bad = bytearray(want)
    bad[i] ^= 0x01
    assert _port(frames, w, h, q) == want
    assert _port(frames, w, h, q) != bytes(bad)


def test_intra_chunks_count_every_chunk():
    """A clip longer than one chunk of the intra path (64 frames of 64x48)
    counts each chunk."""
    w, h, n = 64, 48, 70
    frames = _frames(w, h, n, seed=5)
    got = _port(frames, w, h, 85)
    assert STATS["intra_chunks"] == 2 and STATS["core_i"] == n
    assert got == _ref(frames, w, h, 85)


def _spans(fn):
    STATS.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events()
             if e.name.startswith(("gop.", "encode."))]
    return out, spans, dict(STATS)


def _count(spans, name):
    return sum(1 for s, _a, _b in spans if s == name)


def _inside(spans, inner, outer):
    outs = [(a, b) for s, a, b in spans if s == outer]
    return [any(a <= x and y <= b for a, b in outs)
            for s, x, y in spans if s == inner]


@pytest.mark.parametrize("case", ["cif_q85", "cif_q100_dense"])
def test_intra_spans(case):
    """A span of each step a chunk: the core, the compaction and the reads
    apart; on the dense route a `gop.intra_scan` a picture inside
    `gop.pack`."""
    w, h, n, q, dense = CASES[case]
    frames = _frames(w, h, n)
    want = _port(frames, w, h, q)
    got, spans, st = _spans(lambda: _port(frames, w, h, q))
    assert got == want
    chunks = st["intra_chunks"]
    for name in ("gop.upload", "gop.intra_core", "gop.intra_compact",
                 "gop.pack"):
        assert _count(spans, name) == chunks, name
    assert _count(spans, "encode.read") == chunks + st.get(
        "overflow_redos", 0)
    assert not any(_inside(spans, "encode.read", "gop.intra_core"))
    assert not any(_inside(spans, "encode.read", "gop.intra_compact"))
    scans = _inside(spans, "gop.intra_scan", "gop.pack")
    assert len(scans) == (n if dense else 0) and all(scans)
