"""The port's host spans and read counters, on the CPU.

A CRF GOP encode (one clip that fits the compaction's caps, one cut to
noise at a high quality whose P planes overflow them), a CLI encode and
decode, and a GOP decode run under torch.profiler with CPU activity:

- each span of the frame intake (`encode.intake`), the blocking reads
  (`encode.read`, `decode.read`), a request's end (`encode.finish`),
  the CLI's file I/O (`cli.read`, `cli.write`) and the decode's steps
  (`decode.parse`, `decode.upload`, `decode.chain`) appears as many
  times as there are chunks, frames or requests;
- no span is open while the generators that hold them hand work on: no
  `encode.intake` overlaps the chunk's `gop.*` spans, and no `decode.*`
  span overlaps a consumer that sleeps between decoded frames;
- `STATS["d2h_bytes"]` is the sum of the `nbytes` the reads returned,
  `host_reads` their number (plus a per-frame ABR quality read);
- every chunk packed from its dense planes counts the cap that
  overflowed (`overflow_i` or `overflow_p`);
- streams and decoded planes are the same with and without the
  profiler."""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import dsv1_tpu_torch as dt
from dsv1_tpu_torch import cli as tcli
from dsv1_tpu_torch.parallel import decode as pdec
from dsv1_tpu_torch.parallel import gop as pgop
from dsv1_tpu_torch.utils import blob
from dsv1_tpu_torch.utils.corpus import make_clip, split_frames
from dsv1_tpu_torch.utils.stats import STATS

torch.set_num_threads(1)

W, H, N = 96, 64, 13
META = dt.Metadata(W, H, dt.SUBSAMP_420)
PREFIXES = ("encode.", "decode.", "cli.", "gop.", "test.")


def _spans(prof) -> list:
    """(name, start, end) of the profiled block's named spans."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name.startswith(PREFIXES)]


def _count(spans, name: str) -> int:
    return sum(1 for n, _a, _b in spans if n == name)


def _overlap(spans, a: str, b: str) -> bool:
    """Whether a span named (or prefixed) `a` overlaps one named `b`."""
    xs = [(s, e) for n, s, e in spans if n.startswith(a)]
    ys = [(s, e) for n, s, e in spans if n.startswith(b)]
    return any(s0 < e1 and s1 < e0 for s0, e0 in xs for s1, e1 in ys)


def _profiled(fn):
    """(fn()'s result, its spans, STATS over it)."""
    STATS.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof), dict(STATS)


@pytest.fixture
def reads(monkeypatch):
    """The nbytes of every array the counted host reads return."""
    got = []

    def wrap(f):
        def counted(*a, **kw):
            out = f(*a, **kw)
            arrays = out.values() if isinstance(out, dict) else [out]
            got.append(sum(x.nbytes for x in arrays))
            return out
        return counted
    # gop.py and decode.py hold their own names of the functions;
    # fetch_dense reads through blob.fetch
    for mod, name in ((pgop, "fetch"), (blob, "fetch"), (pgop, "to_host"),
                      (pdec, "to_host")):
        monkeypatch.setattr(mod, name, wrap(getattr(mod, name)))
    return got


def _noise_cut():
    """Two flat frames, then noise: at quality 95 % the forced-intra P
    slot's planes overflow the sparse cap (tests/test_torch_compact.py)."""
    rng = np.random.default_rng(11)
    flat = [(np.full((H, W), 60, np.uint8),
             np.full((H // 2, W // 2), 128, np.uint8),
             np.full((H // 2, W // 2), 128, np.uint8)) for _ in range(2)]
    noisy = [(rng.integers(0, 256, (H, W), dtype=np.uint8),
              rng.integers(0, 256, (H // 2, W // 2), dtype=np.uint8),
              rng.integers(0, 256, (H // 2, W // 2), dtype=np.uint8))
             for _ in range(N - 2)]
    return flat + noisy, 95


def _rich():
    yuv = make_clip(W, H, dt.SUBSAMP_420, N, seed=5)
    return split_frames(yuv, W, H, dt.SUBSAMP_420, N), 85


@pytest.mark.parametrize("clip", ["rich", "noise_cut"])
def test_gop_encode_spans_reads_and_caps(clip, reads):
    frames, pct = {"rich": _rich, "noise_cut": _noise_cut}[clip]()
    cfg = dt.EncoderConfig(quality=dt.quality_percent(pct), gop=4,
                           stable_refresh=3)
    want = dt.encode_stream_gops(frames, META, cfg, device="cpu")
    reads.clear()
    got, spans, st = _profiled(
        lambda: dt.encode_stream_gops(frames, META, cfg, device="cpu"))
    assert got == want
    chunks, redos = st["chunks"], st.get("overflow_redos", 0)
    # one intake a chunk and one for the pull that finds the end
    assert _count(spans, "encode.intake") == chunks + 1
    # a chunk's verdicts and compacted planes, and its dense planes on
    # overflow
    assert _count(spans, "encode.read") == 2 * chunks + redos
    assert _count(spans, "encode.finish") == 1
    assert not _overlap(spans, "encode.intake", "gop.")
    # the reads above and the state read at the end
    assert len(reads) == st["host_reads"] == 2 * chunks + redos + 1
    assert st["d2h_bytes"] == sum(reads)
    # every redone chunk names its cap, and no chunk names one for nothing
    assert redos <= st["overflow_i"] + st["overflow_p"]
    assert max(st["overflow_i"], st["overflow_p"]) <= redos
    if clip == "noise_cut":
        assert redos >= 1 and st["overflow_p"] >= 1
    else:
        assert redos == 0


def test_cli_encode_and_decode_spans(tmp_path, reads):
    (tmp_path / "in.yuv").write_bytes(make_clip(W, H, dt.SUBSAMP_420, N,
                                                seed=21))
    enc = ["e", f"-inp_{tmp_path}/in.yuv", f"-w{W}", f"-h{H}", "-y"]
    assert tcli.main([*enc, f"-out_{tmp_path}/a.dsv"], device="cpu") == 0
    reads.clear()
    rc, spans, st = _profiled(lambda: tcli.main(
        [*enc, f"-out_{tmp_path}/b.dsv"], device="cpu"))
    assert rc == 0
    stream = (tmp_path / "a.dsv").read_bytes()
    assert (tmp_path / "b.dsv").read_bytes() == stream
    # the CLI's defaults: per-frame ABR, one GOP of 12 a chunk
    chunks = st["chunks"]
    assert chunks == 2
    assert _count(spans, "cli.read") == N + 1   # the last finds the end
    assert _count(spans, "cli.write") == 1
    assert _count(spans, "encode.intake") == chunks + 1
    assert _count(spans, "encode.finish") == 1
    # every frame read happens while a chunk is taken in
    intake = [(a, b) for n, a, b in spans if n == "encode.intake"]
    assert all(any(a <= s and e <= b for a, b in intake)
               for n, s, e in spans if n == "cli.read")
    assert not _overlap(spans, "encode.intake", "gop.")
    # one quality read a frame besides the counted copies
    assert _count(spans, "gop.rate_read") == N
    assert st["host_reads"] == len(reads) + N
    assert st["d2h_bytes"] == sum(reads)

    dec = ["d", f"-inp_{tmp_path}/a.dsv", "-y"]
    assert tcli.main([*dec, f"-out_{tmp_path}/a.yuv"], device="cpu") == 0
    rc, spans, _st = _profiled(lambda: tcli.main(
        [*dec, f"-out_{tmp_path}/b.yuv"], device="cpu"))
    assert rc == 0
    assert (tmp_path / "b.yuv").read_bytes() == \
        (tmp_path / "a.yuv").read_bytes()
    assert _count(spans, "cli.write") == N
    assert not _overlap(spans, "decode.", "cli.write")


def test_decode_spans_leave_out_the_consumer(reads):
    frames, _ = _rich()
    stream = dt.encode_stream_gops(
        frames, META, dt.EncoderConfig(quality=dt.quality_percent(85),
                                       gop=4), device="cpu")
    want = dt.decode_stream_gops(stream, device="cpu")[1]
    meta, parsed = pdec._parse_stream(stream)
    chains = pdec._plan_stream(parsed)
    n_chunks = -(-len(chains) // pdec.chains_per_device(chains, W, H))
    reads.clear()

    def consume():
        out = []
        for fno, planes in pdec.iter_decode_gops(stream, device="cpu"):
            out.append((fno, planes))
            with record_function("test.sleep"):
                time.sleep(0.05)
        return out
    got, spans, st = _profiled(consume)
    assert len(got) == len(want) == N
    for (fa, pa), (fb, pb) in zip(got, want):
        assert fa == fb
        assert all(np.array_equal(a, b) for a, b in zip(pa, pb))
    assert _count(spans, "test.sleep") == N
    assert _count(spans, "decode.parse") == 1
    for name in ("decode.upload", "decode.chain", "decode.read"):
        assert _count(spans, name) == n_chunks
    assert not _overlap(spans, "decode.", "test.sleep")
    assert st["host_reads"] == len(reads) == n_chunks
    assert st["d2h_bytes"] == sum(reads)
