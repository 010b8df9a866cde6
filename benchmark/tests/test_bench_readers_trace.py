"""The readers of the program's intake, read, file I/O and decode spans
and of its read and overflow counters (harness/hostspans.py), each on a
small canned trace: the arithmetic, and None where there is nothing to
read (the other op, no frames, a program without the spans or the
counters)."""

import pytest

from harness import spec, trace
from harness.trace import Trace

ENC_SPANS = [
    ("bench.request", 0.0, 100.0),
    ("encode.intake", 0.0, 10.0), ("cli.read", 2.0, 5.0),
    ("cli.read", 6.0, 8.0),
    ("gop.motion", 10.0, 20.0), ("encode.read", 15.0, 20.0),
    ("gop.recon_chain", 20.0, 60.0), ("encode.read", 55.0, 60.0),
    ("gop.pack", 60.0, 80.0),
    ("encode.finish", 80.0, 84.0), ("cli.write", 86.0, 90.0),
]
DEC_SPANS = [
    ("bench.request", 0.0, 100.0), ("decode.parse", 0.0, 30.0),
    ("decode.upload", 30.0, 40.0), ("decode.chain", 40.0, 70.0),
    ("decode.read", 70.0, 75.0),
]
COUNTERS = {
    "encode": {"chunks": 4, "overflow_redos": 2, "overflow_i": 2,
               "overflow_p": 1, "d2h_bytes": 5_000_000, "host_reads": 30},
    "decode": {"d2h_bytes": 2_000_000, "host_reads": 5},
}


def canned(op: str, spans=None, counters=None) -> Trace:
    return Trace(op=op, frames=10, frames_p=8, geo={}, chips=1,
                 kernels={0: []}, ops={0: [(20.0, 25.0)]},
                 spans=((ENC_SPANS if op == "encode" else DEC_SPANS)
                        if spans is None else spans),
                 counters=dict(COUNTERS[op] if counters is None
                               else counters))


# (metric, op, value) on the canned trace of 10 frames; times in ms
WANT = [
    ("encode.intake_ms", "encode", 10e-3 / 10),
    ("encode.read_ms", "encode", 10e-3 / 10),
    ("encode.finish_ms", "encode", 4e-3 / 10),
    ("cli.io_ms", "encode", 9e-3 / 10),
    # 84-86 and 90-100 lie under no program span
    ("encode.unattributed_ms", "encode", 12e-3 / 10),
    ("decode.parse_ms", "decode", 30e-3 / 10),
    ("decode.upload_ms", "decode", 10e-3 / 10),
    ("decode.chain_ms", "decode", 30e-3 / 10),
    ("decode.read_ms", "decode", 5e-3 / 10),
    ("decode.unattributed_ms", "decode", 25e-3 / 10),
    ("d2h_mb_per_frame.encode", "encode", 0.5),
    ("d2h_mb_per_frame.decode", "decode", 0.2),
    ("host_reads_per_frame.encode", "encode", 3.0),
    ("host_reads_per_frame.decode", "decode", 0.5),
    ("overflow_p_share", "encode", 25.0),
]
NAMES = [w[0] for w in WANT]
UNATTRIBUTED = ("encode.unattributed_ms", "decode.unattributed_ms")


@pytest.mark.parametrize("name,op,value", WANT, ids=NAMES)
def test_reader_on_canned_trace(name, op, value):
    read = spec.reader(name)
    assert read(canned(op)) == pytest.approx(value, rel=1e-12)
    other = "decode" if op == "encode" else "encode"
    assert read(canned(other)) is None


@pytest.mark.parametrize("name", NAMES)
def test_reader_finds_nothing_without_frames(name):
    t = canned(WANT[NAMES.index(name)][1])
    t.frames = 0
    assert spec.reader(name)(t) is None


@pytest.mark.parametrize("name", NAMES)
def test_reader_of_a_program_without_the_spans_or_counters(name):
    """A program with none of these spans or counters (only the request
    span, the counters of the first benchmark): every reader gives None but the
    unattributed time, which is then the whole request."""
    op = WANT[NAMES.index(name)][1]
    t = canned(op, spans=[("bench.request", 0.0, 100.0)],
               counters={"chunks": 4, "overflow_redos": 1})
    got = spec.reader(name)(t)
    if name in UNATTRIBUTED:
        assert got == pytest.approx(100e-3 / 10)
    else:
        assert got is None


def test_overflow_p_share_reads_zero_where_no_p_cap_overflowed():
    t = canned("encode", counters={"chunks": 4, "overflow_p": 0})
    assert spec.reader("overflow_p_share")(t) == 0.0


def test_span_reader_counts_nested_spans_once():
    """`cli.io_ms` over a write inside a read counts their union."""
    spans = [("bench.request", 0.0, 100.0), ("cli.read", 0.0, 20.0),
             ("cli.write", 5.0, 25.0)]
    assert spec.reader("cli.io_ms")(canned("encode", spans=spans)) == \
        pytest.approx(25e-3 / 10)


def test_breakdown_books_idle_to_the_innermost_new_span():
    """Idle time inside `encode.read` (in `gop.motion`) goes to
    `encode.read`; inside `encode.intake`, outside `cli.read`, to the
    intake; past every program span, to the request."""
    b = trace.breakdown(canned("encode"))
    gaps = dict((k, v) for k, v in b["idle_gaps"])
    # device busy 20-25 only: 0-20 and 25-100 idle
    assert gaps["cli.read"] == pytest.approx(5e-6)
    assert gaps["encode.intake"] == pytest.approx(5e-6)
    assert gaps["encode.read"] == pytest.approx(5e-6 + 5e-6)
    assert gaps["gop.motion"] == pytest.approx(5e-6)
    assert gaps["encode.finish"] == pytest.approx(4e-6)
    assert gaps["cli.write"] == pytest.approx(4e-6)
    assert gaps["bench.request"] == pytest.approx(12e-6)


def test_new_metrics_follow_the_accepted_ones():
    """BENCHMARK.json keeps the accepted per-layer metrics first, in order;
    each new one lists the cells it reads, all reporting its `moves`."""
    bench = spec.load()
    names = [m["name"] for m in bench["per_layer"]]
    first = ["gop.recon_chain_ms", "gop.pack_ms", "gop.motion_ms",
             "gop.rate_read_ms", "encode.unspanned_ms", "overflow_share",
             "kernels_per_frame.encode", "roofline.encode",
             "device_idle.encode", "kernels_per_frame.decode",
             "roofline.decode", "device_idle.decode"]
    assert names[:len(first)] == first
    assert sorted(names[len(first):]) == sorted(NAMES)
    for m in bench["per_layer"][len(first):]:
        op = WANT[NAMES.index(m["name"])][1]
        assert m["moves"] == f"{op}_fps"
        assert m["source"] in ("program_span", "program_counter")
        assert m["workloads"] and all(w.endswith("." + op) for w in
                                      m["workloads"])
