"""The traced slice: a fixed number of whole requests under
torch.profiler, reduced to kernel and span intervals that the per-layer
readers (metrics/*.py) take their numbers from.

The profiler's trace is written by Kineto straight to a JSON file under
TMPDIR (no Python event tree is built), read back, and deleted.
Timestamps are microseconds on one clock for host spans and device
events."""

import json
import os
import tempfile
from dataclasses import dataclass, field
from pathlib import Path

REQUEST = "bench.request"   # the benchmark's own span around a request
DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")


def union(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur = 0.0, None
    for a, b in sorted(intervals):
        if cur is None or a > cur[1]:
            total += 0 if cur is None else cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    return total + (0 if cur is None else cur[1] - cur[0])


def clip(intervals, t0: float, t1: float) -> list:
    return [(max(a, t0), min(b, t1)) for a, b in intervals
            if b > t0 and a < t1]


def gaps(intervals, t0: float, t1: float) -> list:
    """The (start, end) gaps in [t0, t1] that no interval covers."""
    out, cur = [], t0
    for a, b in sorted(clip(intervals, t0, t1)):
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if t1 > cur:
        out.append((cur, t1))
    return out


@dataclass
class Trace:
    """What a reader sees of the traced slice. Times in microseconds.

    op: "encode" or "decode"; frames: frames the slice's requests
    encoded or decoded; frames_p: of them P frames (the program's
    counters); geo: the frame geometry (harness/geometry.py frame);
    kernels: per card [(start, end, name)]; ops: per card the intervals
    of every device operation (kernels, copies, sets); spans: host spans
    [(name, start, end)], the program's and the benchmark's request
    spans; counters: the program's STATS added over the slice; peaks:
    the card's published peaks (peaks.json) or None."""
    op: str
    frames: int
    frames_p: int
    geo: dict
    chips: int
    kernels: dict = field(default_factory=dict)
    ops: dict = field(default_factory=dict)
    spans: list = field(default_factory=list)
    counters: dict = field(default_factory=dict)
    peaks: dict | None = None

    @property
    def requests(self) -> list:
        return [(a, b) for n, a, b in self.spans if n == REQUEST]

    @property
    def window(self) -> tuple:
        r = self.requests
        return min(a for a, _ in r), max(b for _, b in r)

    def span_total(self, name: str) -> float:
        return sum(b - a for n, a, b in self.spans if n == name)

    def busy(self, card) -> float:
        """Microseconds of the window in which a device operation ran."""
        return union(clip(self.ops.get(card, []), *self.window))

    def kernel_time(self, card) -> float:
        """Microseconds of the window in which a kernel ran."""
        return union(clip([(a, b) for a, b, _ in self.kernels.get(card, [])],
                          *self.window))

    def kernel_count(self) -> int:
        t0, t1 = self.window
        return sum(1 for ks in self.kernels.values() for a, _b, _ in ks
                   if t0 <= a < t1)


def read_chrome_trace(path: Path):
    """(kernels, ops, spans) of an exported profiler trace."""
    events = json.loads(path.read_text()).get("traceEvents", [])
    kernels, ops, spans = {}, {}, []
    for e in events:
        cat, dur = e.get("cat"), e.get("dur")
        if dur is None or e.get("ph") != "X":
            continue
        a = float(e["ts"])
        b = a + float(dur)
        if cat in DEVICE_OPS:
            card = e.get("args", {}).get("device", 0)
            ops.setdefault(card, []).append((a, b))
            if cat == "kernel":
                kernels.setdefault(card, []).append((a, b, e.get("name", "")))
        elif cat == "user_annotation":
            spans.append((e.get("name", ""), a, b))
    return kernels, ops, spans


def profile(fn):
    """Run fn() under torch.profiler (host and CUDA activity); returns
    (fn's result, kernels, ops, spans)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        out = fn()
    fd, name = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    path = Path(name)
    try:
        prof.export_chrome_trace(str(path))
        return (out, *read_chrome_trace(path))
    finally:
        path.unlink(missing_ok=True)


def breakdown(t: Trace, n: int = 10) -> dict:
    """The device operations that took most time (seconds summed over
    the cards, by kernel name) and the device's idle time by what the
    host was doing: each gap on each card, cut at the spans' edges, its
    pieces named by the innermost span open there (a program span, else
    the request span), summed by name."""
    t0, t1 = t.window
    by_op = {}
    for ks in t.kernels.values():
        for a, b, name in ks:
            if a >= t0 and a < t1:
                by_op[name] = by_op.get(name, 0.0) + (b - a) * 1e-6
    idle = {}
    spans = sorted(t.spans, key=lambda s: s[2] - s[1])
    edges = sorted({e for _n, x, y in t.spans for e in (x, y)})
    for card in t.ops:
        for a, b in gaps(t.ops[card], t0, t1):
            # split at span edges: each piece goes to the innermost span
            cuts = [a] + [e for e in edges if a < e < b] + [b]
            for x0, x1 in zip(cuts, cuts[1:]):
                name = next((s for s, x, y in spans if x <= x0 < y),
                            "outside")
                idle[name] = idle.get(name, 0.0) + (x1 - x0) * 1e-6
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:n]
    gap = sorted(idle.items(), key=lambda kv: -kv[1])[:n]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in gap]}
