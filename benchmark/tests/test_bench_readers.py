"""Each per-layer reader on a small canned trace, and the reduction of an
exported profiler trace to kernel and span intervals."""

import json

import pytest

from harness import spec, trace
from harness.trace import Trace

GEO = {"planes": [(16, 8, 4), (8, 4, 4), (8, 4, 4)],
       "dims": [(16, 8), (8, 4), (8, 4)], "n": [128, 32, 32], "blocks": 2}
KERNELS = {0: [(0.0, 10.0, "a"), (5.0, 20.0, "b"), (30.0, 40.0, "a")]}
OPS = {0: [(0.0, 20.0), (30.0, 40.0), (50.0, 55.0)]}
SPANS = [("bench.request", 0.0, 100.0), ("gop.motion", 0.0, 10.0),
         ("gop.recon_chain", 10.0, 60.0), ("gop.rate_read", 20.0, 30.0),
         ("gop.pack", 60.0, 80.0)]
PEAKS = {"hbm_bytes_per_s": 1e12}


def canned(op: str) -> Trace:
    return Trace(op=op, frames=10, frames_p=8, geo=GEO, chips=1,
                 kernels=KERNELS, ops=OPS, spans=SPANS,
                 counters={"chunks": 4, "overflow_redos": 1}, peaks=PEAKS)


def least_bytes(families) -> int:
    return sum(spec.work(f)(GEO, True) * 8 + spec.work(f)(GEO, False) * 2
               for f in families)


ENC = ("mc", "haar", "residual_in", "b4t_fwd", "hzcc_quant", "inv_sbt")
DEC = ("mc", "hzcc_dequant", "inv_sbt")
# (metric, op, value); a reader of the other op reads nothing
WANT = [
    ("gop.recon_chain_ms", "encode", 40e-3 / 10),
    ("gop.pack_ms", "encode", 20e-3 / 10),
    ("gop.motion_ms", "encode", 10e-3 / 10),
    ("gop.rate_read_ms", "encode", 10e-3 / 10),
    ("encode.unspanned_ms", "encode", 20e-3 / 10),
    ("overflow_share", "encode", 25.0),
    ("kernels_per_frame.encode", "encode", 0.3),
    ("kernels_per_frame.decode", "decode", 0.3),
    ("device_idle.encode", "encode", 65.0),
    ("device_idle.decode", "decode", 65.0),
    ("roofline.encode", "encode",
     100 * least_bytes(ENC) / 1e12 / 30e-6),
    ("roofline.decode", "decode",
     100 * least_bytes(DEC) / 1e12 / 30e-6),
]


@pytest.mark.parametrize("name,op,value", WANT, ids=[w[0] for w in WANT])
def test_reader_on_canned_trace(name, op, value):
    read = spec.reader(name)
    assert read(canned(op)) == pytest.approx(value, rel=1e-12)
    other = "decode" if op == "encode" else "encode"
    assert read(canned(other)) is None


@pytest.mark.parametrize("name", [w[0] for w in WANT])
def test_reader_finds_nothing_without_frames(name):
    t = canned(WANT[[w[0] for w in WANT].index(name)][1])
    t.frames = 0
    t.counters = {}
    assert spec.reader(name)(t) is None


def test_roofline_reads_nothing_without_peaks():
    t = canned("encode")
    t.peaks = None
    assert spec.reader("roofline.encode")(t) is None


def test_breakdown_names_gaps_by_innermost_span():
    b = trace.breakdown(canned("encode"))
    assert b["device_ops"][0] == ["a", pytest.approx(20e-6)]
    gaps = dict((k, v) for k, v in b["idle_gaps"])
    # gaps: 20-30 in gop.rate_read, 40-50 in gop.recon_chain, 55-60 in
    # gop.recon_chain, 60-80 in gop.pack, 80-100 in the request alone
    assert gaps == pytest.approx({"gop.rate_read": 10e-6,
                                  "gop.recon_chain": 15e-6,
                                  "gop.pack": 20e-6,
                                  "bench.request": 20e-6})


def test_union_and_gaps():
    assert trace.union([(0, 2), (1, 3), (5, 6)]) == 4
    assert trace.gaps([(1, 2), (3, 4)], 0, 5) == [(0, 1), (2, 3), (4, 5)]


def test_chrome_trace_reduction(tmp_path):
    events = [
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10, "dur": 5,
         "args": {"device": 1}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 20,
         "dur": 2, "args": {"device": 1}},
        {"ph": "X", "cat": "user_annotation", "name": "gop.pack", "ts": 1,
         "dur": 30},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 3,
         "dur": 1},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 4},
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": events}))
    kernels, ops, spans = trace.read_chrome_trace(p)
    assert kernels == {1: [(10.0, 15.0, "k1")]}
    assert ops == {1: [(10.0, 15.0), (20.0, 22.0)]}
    assert spans == [("gop.pack", 1.0, 31.0)]
