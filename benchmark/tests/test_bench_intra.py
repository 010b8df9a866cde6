"""The intra-only cell (intra_4k.encode) and what it adds: its plain
reference (reference/dsvintra) against the program and against the JAX
package's golden hashes, the control on it, the cell's run on the CPU
(sound, traced, and with faults underneath), and the readers of the
intra path's spans and counters on canned traces."""

import json
import subprocess
import sys

import pytest
import torch

import helpers
from harness import check, corpus, spec
from harness.spec import BENCH
from harness.trace import Trace

CELL = "intra_4k.encode"
BENCH_SPEC = spec.load()
CFG = spec.config(BENCH_SPEC, "intra_4k")


def intra_cfg(w: int, h: int, quality_pct: int = 85) -> dict:
    return dict(CFG, width=w, height=h, quality_pct=quality_pct)


def clip_frames(w: int, h: int, n: int, seed: int):
    return corpus.split_frames(corpus.make_rich_clip(w, h, 5, n, seed=seed),
                               w, h, 5, n)


# the reference against the program, on the two routes of the intra path
# (compacted, and read back dense where the I cap overflows) and at a size
# that is no multiple of the block size
ROUTES = [(352, 288, 3, 85, False), (352, 288, 2, 100, True),
          (200, 120, 3, 85, False)]


@pytest.mark.parametrize("w,h,n,q,dense", ROUTES,
                         ids=["cif_q85", "cif_q100_dense", "200x120"])
def test_dsvintra_matches_the_program(w, h, n, q, dense):
    import dsv1_tpu_torch as dt
    from dsv1_tpu_torch.utils.stats import STATS
    torch.set_num_threads(2)
    cfg = intra_cfg(w, h, q)
    frames = clip_frames(w, h, n, seed=2**33 + 21)
    ref = check.Reference(cfg, torch.device("cpu"))
    assert ref.ref.__name__ == "dsvintra"
    want = ref.encode(frames)
    STATS.clear()
    got = dt.encode_stream_gops(
        frames, dt.Metadata(w, h, 5),
        dt.EncoderConfig(quality=dt.quality_percent(q), gop=0), "cpu")
    assert check.diff_bytes(got, want) == 0
    assert STATS["intra_chunks"] == 1
    assert (STATS["overflow_redos"] > 0) == dense
    assert len(ref.decode(want)) == n


def test_dsvintra_delegates_every_other_gop_to_dsvref():
    import dsvref
    import dsvintra
    frames = clip_frames(96, 80, 13, seed=2**33 + 5)
    meta = dsvref.Metadata(96, 80, 5)
    cfg = dsvref.EncoderConfig(quality=dsvref.quality_percent(85), gop=12)
    assert dsvintra.encode_stream_gops(frames, meta, cfg, "cpu") == \
        dsvref.encode_stream_gops(frames, meta, cfg, "cpu")
    with pytest.raises(ValueError):
        dsvintra.encode_stream_gops(frames, meta, dsvref.EncoderConfig(
            gop=0, rc_mode=dsvref.RATE_CONTROL_ABR), "cpu")


def test_control_breaks_dsvintra_and_not_dsvref():
    """check.control() on intra_4k replaces dsvintra's rounding shifts
    (its own forward transform's), leaves dsvref's alone, and puts them
    back."""
    import dsvref
    torch.set_num_threads(2)
    cfg = intra_cfg(160, 128)
    ref = check.Reference(cfg, torch.device("cpu"))
    frames = clip_frames(160, 128, 2, seed=2**34 + 1)
    want = ref.encode(frames)
    gop_cfg = dsvref.EncoderConfig(quality=dsvref.quality_percent(85), gop=2)
    meta = dsvref.Metadata(160, 128, 5)
    gop_want = dsvref.encode_stream_gops(frames, meta, gop_cfg, "cpu")
    sbt = sys.modules["dsvintra.ops.sbt"]
    kept = sbt.round2, sbt.round4, sbt.round8
    own = sys.modules["dsvref.ops.sbt"].round2
    with check.control(cfg):
        assert sbt.round2 is not kept[0]
        assert sys.modules["dsvref.ops.sbt"].round2 is own
        assert check.diff_bytes(ref.encode(frames), want) > 0
        assert dsvref.encode_stream_gops(frames, meta, gop_cfg, "cpu") == \
            gop_want
    assert (sbt.round2, sbt.round4, sbt.round8) == kept
    assert check.diff_bytes(ref.encode(frames), want) == 0


GOLDEN = spec.ROOT / "dsv1_tpu_torch" / "data" / "golden.json"


@pytest.mark.parametrize("name", ["1080p_gop0_cli", "cif_cli"])
def test_dsvintra_cli_matches_the_goldens_on_the_cpu(name, tmp_path):
    """dsvintra's CLI against the JAX package's golden hashes: the intra
    route (`1080p_gop0_cli`, -gop0 -rc_mode1) and a route it hands to
    dsvref (`cif_cli`, the defaults)."""
    import hashlib

    import dsvintra
    from dsvintra import cli
    from test_bench_golden import SEED, decoded_bytes, make_clip
    torch.set_num_threads(2)
    gold = json.loads(GOLDEN.read_text())[name]
    w, h, n = gold["width"], gold["height"], gold["frames"]
    gen = corpus.make_rich_clip if w > 352 else make_clip
    yuv = gen(w, h, 5, n, seed=SEED)
    assert hashlib.sha256(yuv).hexdigest() == gold["clip_sha256"]
    inp, out = tmp_path / "in.yuv", tmp_path / "out.dsv"
    inp.write_bytes(yuv)
    argv = [gold["argv"][0], f"-inp_{inp}", f"-out_{out}",
            *gold["argv"][1:]]
    assert cli.main(argv, device="cpu") == 0
    stream = out.read_bytes()
    assert len(stream) == gold["stream_bytes"]
    assert hashlib.sha256(stream).hexdigest() == gold["stream_sha256"]
    _meta, dec = dsvintra.decode_stream_gops(stream, "cpu")
    assert len(dec) == n
    assert hashlib.sha256(decoded_bytes(dec)).hexdigest() == \
        gold["decode_sha256"]


REF_ONLY = r"""
import json, sys
sys.path[:0] = [sys.argv[1]]
import numpy as np
import dsvintra
from dsvintra import cli
meta = dsvintra.Metadata(64, 48, 5)
cfg = dsvintra.EncoderConfig(quality=dsvintra.quality_percent(85), gop=0)
frames = [(np.full((48, 64), 100, np.uint8), np.full((24, 32), 128, np.uint8),
           np.full((24, 32), 128, np.uint8))] * 3
s = dsvintra.encode_stream_gops(frames, meta, cfg, "cpu")
dsvintra.decode_stream_gops(s, "cpu")
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

CELL_PATH = r"""
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2], sys.argv[3]]
import helpers
out = helpers.run_small("intra_4k.encode")
print(json.dumps({"correct": out["correct"],
                  "roots": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def test_dsvintra_loads_nothing_of_the_program():
    r = subprocess.run([sys.executable, "-c", REF_ONLY,
                        str(BENCH / "reference")], capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    roots = set(json.loads(r.stdout.strip().splitlines()[-1]))
    assert "dsvintra" in roots and "dsvref" in roots
    assert not roots & {"dsv1_tpu_torch", "dsv1_tpu", "jax", "jaxlib",
                        "flax"}


def test_intra_cell_code_path_loads_no_jax():
    r = subprocess.run([sys.executable, "-c", CELL_PATH, str(BENCH.parent),
                        str(BENCH), str(BENCH / "tests")],
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"]
    roots = set(out["roots"])
    assert not roots & {"jax", "jaxlib", "flax", "dsv1_tpu"}
    assert {"dsv1_tpu_torch", "dsvintra"} <= roots


# the cell on the CPU: sound, traced, and with faults underneath


def test_sound_run_is_correct():
    out = helpers.run_small(CELL)
    assert out["correct"], out["checks"]
    assert out["attempted"] == 1 and out["failed"] == 0
    assert set(out["checks"]) == {"stream_diff_bytes", "failed_requests"}


NEW = ("gop.intra_core_ms", "gop.intra_compact_ms", "gop.intra_scan_ms",
       "intra.overflow_share", "intra.dense_mb_per_frame")


def test_traced_run_reads_the_intra_metrics():
    """At qp 100 every frame of the cut cell overflows, as every UHD frame
    does at qp 85: each new reader of the program's spans and counters
    reads (roofline.intra needs a card's peaks)."""
    out = helpers.run_small(CELL, traced=True, cfg_keys={"quality_pct": 100})
    assert out["correct"], out["checks"]
    listed = {m["name"] for m in spec.metrics(BENCH_SPEC, CELL, True)}
    assert set(out["metrics"]) <= listed
    assert set(NEW) <= set(out["metrics"])
    assert out["metrics"]["intra.overflow_share"]["value"] == 100.0
    assert out["metrics"]["intra.dense_mb_per_frame"]["value"] > 0
    for name in ("gop.pack_ms", "encode.read_ms", "encode.intake_ms",
                 "encode.unattributed_ms", "d2h_mb_per_frame.encode",
                 "host_reads_per_frame.encode"):
        assert name in out["metrics"], name


def half_left_out(mp):
    import dsv1_tpu_torch as dt
    enc = dt.encode_stream_gops

    def half(frames, *a, **k):
        frames = list(frames)
        return enc(frames[:len(frames) // 2], *a, **k)
    mp.setattr(dt, "encode_stream_gops", half)


def packet_altered(mp):
    """One byte of each chunk's packed pictures flipped, on either
    route."""
    from dsv1_tpu_torch.parallel import gop
    chunk, picture = gop.bits.pack_chunk, gop.pack_picture

    def flipped_chunk(*a, **k):
        pkt, link = chunk(*a, **k)
        pkt = bytearray(pkt)
        pkt[-1] ^= 0x5A
        return bytes(pkt), link

    def flipped_picture(*a, **k):
        pic = picture(*a, **k)
        pic[-1] ^= 0x5A
        return pic
    mp.setattr(gop.bits, "pack_chunk", flipped_chunk)
    mp.setattr(gop, "pack_picture", flipped_picture)


def coarser_quant(mp):
    """The program's quant one step coarser than the configuration's."""
    from dsv1_tpu_torch.parallel import gop
    crf = gop.crf_quant
    mp.setattr(gop, "crf_quant", lambda q: crf(q) + 1)


FAULTS = [(f, q) for f in (half_left_out, packet_altered, coarser_quant)
          for q in (85, 100)]


@pytest.mark.parametrize("fault,q", FAULTS,
                         ids=[f"{f.__name__}-q{q}" for f, q in FAULTS])
def test_fault_is_not_correct(fault, q, monkeypatch):
    fault(monkeypatch)
    out = helpers.run_small(CELL, cfg_keys={"quality_pct": q})
    assert not out["correct"], out["checks"]


# the readers on canned traces (times in microseconds, 10 frames)

SPANS = [
    ("bench.request", 0.0, 100.0), ("encode.intake", 0.0, 5.0),
    ("gop.upload", 5.0, 8.0), ("gop.intra_core", 8.0, 30.0),
    ("gop.intra_compact", 30.0, 34.0), ("encode.read", 34.0, 40.0),
    ("encode.read", 40.0, 60.0), ("gop.pack", 60.0, 95.0),
    ("gop.intra_scan", 62.0, 70.0), ("gop.intra_scan", 72.0, 82.0),
    ("encode.finish", 95.0, 98.0),
]
# a tree whose gop.intra_core wraps the compaction and both reads
WIDE_CORE = [s for s in SPANS if s[0] not in ("gop.intra_core",
                                               "gop.intra_compact")] + [
    ("gop.intra_core", 8.0, 60.0)]
COUNTERS = {"intra_chunks": 10, "overflow_redos": 10,
            "intra_dense_bytes": 500_000_000, "d2h_bytes": 620_000_000,
            "host_reads": 20, "overflow_i": 10}
GEO = {"planes": [(16, 8, 4), (8, 4, 4), (8, 4, 4)],
       "dims": [(16, 8), (8, 4), (8, 4)], "n": [128, 32, 32], "blocks": 2}
FAMILIES = ("residual_in", "b4t_fwd", "haar", "hzcc_quant")


def canned(op="encode", spans=None, counters=None, kernel_us=30.0,
           peak=1e12) -> Trace:
    return Trace(op=op, frames=10, frames_p=0, geo=GEO, chips=1,
                 kernels={0: [(0.0, kernel_us, "k")]},
                 ops={0: [(0.0, kernel_us)]},
                 spans=SPANS if spans is None else spans,
                 counters=dict(COUNTERS if counters is None else counters),
                 peaks={"hbm_bytes_per_s": peak})


def intra_bytes() -> int:
    return 10 * sum(spec.work(f)(GEO, False) for f in FAMILIES)


WANT = [
    ("gop.intra_core_ms", 22e-3 / 10),
    ("gop.intra_compact_ms", 4e-3 / 10),
    ("gop.intra_scan_ms", 18e-3 / 10),
    ("intra.overflow_share", 100.0),
    ("intra.dense_mb_per_frame", 50.0),
    ("roofline.intra", 100 * intra_bytes() / 1e12 / 30e-6),
]
NAMES = [w[0] for w in WANT]


@pytest.mark.parametrize("name,value", WANT, ids=NAMES)
def test_reader_on_canned_trace(name, value):
    read = spec.reader(name)
    assert read(canned()) == pytest.approx(value, rel=1e-12)
    assert read(canned("decode")) is None


@pytest.mark.parametrize("name", NAMES)
def test_reader_finds_nothing_without_frames(name):
    t = canned()
    t.frames = 0
    assert spec.reader(name)(t) is None


@pytest.mark.parametrize("name", [n for n in NAMES if n != "roofline.intra"])
def test_reader_of_a_program_without_the_spans_or_counters(name):
    """The parent's program at gop 0: `gop.intra_core` around everything,
    no other intra span, none of the new counters. The core reads less
    its reads; the others read nothing."""
    t = canned(spans=[s for s in WIDE_CORE if s[0] != "gop.intra_scan"],
               counters={"overflow_redos": 10, "overflow_i": 10,
                         "d2h_bytes": 620_000_000, "host_reads": 20})
    got = spec.reader(name)(t)
    if name == "gop.intra_core_ms":
        assert got == pytest.approx((52 - 26) * 1e-3 / 10)
    else:
        assert got is None


def test_intra_counters_read_zero_where_nothing_overflowed():
    t = canned(counters={"intra_chunks": 10, "d2h_bytes": 1_000,
                         "host_reads": 10})
    assert spec.reader("intra.overflow_share")(t) == 0.0
    assert spec.reader("intra.dense_mb_per_frame")(t) == 0.0


def test_roofline_intra_at_the_bytes_bound_is_100():
    """Kernel time equal to the families' bytes at the peak reads 100 %,
    and longer kernel time less."""
    bound_us = intra_bytes() / 1e12 * 1e6
    read = spec.reader("roofline.intra")
    assert read(canned(kernel_us=bound_us)) == pytest.approx(100.0)
    assert read(canned(kernel_us=bound_us)) <= 100.0 + 1e-9
    assert read(canned(kernel_us=2 * bound_us)) == pytest.approx(50.0)
    t = canned()
    t.peaks = None
    assert read(t) is None


def test_roofline_intra_leaves_out_mc_and_the_inverse():
    """An intra-only frame reconstructs nothing: the families MC and
    inv_sbt, which roofline.encode counts, are not in roofline.intra."""
    enc = spec.reader("roofline.encode")(canned())
    intra = spec.reader("roofline.intra")(canned())
    inv = 10 * spec.work("inv_sbt")(GEO, False)
    assert enc == pytest.approx(intra * (intra_bytes() + inv)
                                / intra_bytes())


def test_the_cell_and_its_metrics_in_the_benchmark():
    cells = {w["name"]: w for w in BENCH_SPEC["workloads"]}
    assert cells[CELL]["chips"] == 1 and cells[CELL]["config"] == "intra_4k"
    assert CFG["gop"] == 0 and CFG["reference"] == "dsvintra"
    e2e = {m["name"] for m in spec.metrics(BENCH_SPEC, CELL, False)}
    assert e2e == {"encode_fps", "setup_s"}
    per = {m["name"]: m for m in BENCH_SPEC["per_layer"]}
    for name in NAMES:
        assert per[name]["workloads"] == [CELL]
        assert per[name]["moves"] == "encode_fps"
    for name in ("roofline.encode", "overflow_share", "gop.recon_chain_ms"):
        assert CELL not in per[name]["workloads"]
