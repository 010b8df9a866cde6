"""One run of one cell: set-up, the warm request, the measured window (or
the traced slice), the comparison with the reference, the result line.

A request is one client's call in a closed loop, the next taken when the
last is done: an encode of a segment (`encode_stream_gops`, or the CLI
from a raw file to a .dsv file), or a decode of a segment's stream."""

import contextlib
import gc
import json
import shutil
import statistics
import sys
import tempfile
import time
import traceback
from pathlib import Path

from . import check, geometry, spec, traffic
from .device import Sampler
from .program import Program
from .trace import REQUEST, Trace, breakdown, profile

FORBIDDEN = ("jax", "jaxlib", "flax", "dsv1_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def p95(values) -> float:
    return statistics.quantiles(values, n=100, method="inclusive")[94]


class Cell:
    """A cell's program, inputs and requests on `devices`."""

    def __init__(self, cfg: dict, tr: dict, seed: int, devices: list,
                 tmp: Path):
        check.package(cfg)   # a bad "reference" fails before any request
        self.cfg, self.tr = cfg, tr
        self.devices = devices
        self.prog = Program(cfg, devices)
        self.order = traffic.order(tr, seed)
        self.keep = traffic.kept(tr, seed)
        self.tmp = tmp
        self.op = tr["op"]
        clips = traffic.pool(cfg, tr, seed)
        self.frames, self.inputs = None, None
        if cfg["api"] == "cli":
            if self.op != "encode":
                raise ValueError("the CLI cells encode")
            self.inputs = [tmp / f"in{k}.yuv" for k in range(len(clips))]
            for p, clip in zip(self.inputs, clips):
                p.write_bytes(clip)
        else:
            self.frames = [traffic.frames(cfg, c) for c in clips]
        self.streams = ([self.prog.encode(f) for f in self.frames]
                        if self.op == "decode" else None)

    def request(self, k: int):
        """Request on pool clip k: its answer (stream bytes or decoded
        frames)."""
        if self.op == "decode":
            return self.prog.decode(self.streams[k])
        if self.cfg["api"] == "cli":
            return self.prog.cli_encode(self.inputs[k], self.tmp / "out.dsv")
        return self.prog.encode(self.frames[k])

    def run(self, seconds: float | None, n: int | None, mark=False):
        """Requests back to back, for `seconds` (whole requests: the
        last one started before the time is up finishes) or `n` of
        them. Returns (latencies s, elapsed s, answers {index: (clip,
        answer)}, failed)."""
        import torch

        def span():
            return (torch.profiler.record_function(REQUEST) if mark
                    else contextlib.nullcontext())
        lat, answers, failed = [], {}, 0
        t0 = time.perf_counter()
        i = 0
        while True:
            k = self.order[i % len(self.order)]
            ts = time.perf_counter()
            try:
                with span():
                    out = self.request(k)
                te = time.perf_counter()
                lat.append(te - ts)
                if self.keep is None or i in self.keep:
                    answers[i] = (k, out)
            except Exception:   # a request that fails counts as failed
                te = time.perf_counter()
                failed += 1
                if failed == 1:
                    traceback.print_exc()
            i += 1
            if (n is not None and i >= n) or \
                    (seconds is not None and te - t0 >= seconds):
                return lat, te - t0, answers, failed


def compare(cell: Cell, answers: dict, dev) -> dict:
    """The numbers compared, each beside its limit."""
    ref = check.Reference(cell.cfg, dev)
    clips = sorted({k for k, _ in answers.values()})
    nums = {}
    if cell.op == "encode":
        want = {}
        for k in clips:
            want[k] = (ref.cli_encode(cell.inputs[k], cell.tmp / "ref.dsv")
                       if cell.cfg["api"] == "cli"
                       else ref.encode(cell.frames[k]))
        nums["stream_diff_bytes"] = max(
            (check.diff_bytes(a, want[k]) for k, a in answers.values()),
            default=0)
    else:
        diff_in, diff_out = 0, 0
        for k in clips:
            stream = ref.encode(cell.frames[k])
            diff_in = max(diff_in, check.diff_bytes(cell.streams[k], stream))
            want = ref.decode(stream)
            for kk, got in answers.values():
                if kk == k:
                    diff_out = max(diff_out, check.diff_frames(got, want))
        nums["input_stream_diff_bytes"] = diff_in
        nums["decoded_diff_samples"] = diff_out
    return nums


def refuse_jax():
    found = forbidden_modules()
    if found:
        raise SystemExit("JAX or the JAX package was loaded: "
                         + ", ".join(found))


def traced(cell: Cell, bench: dict, name: str, kind: str, say) -> tuple:
    """The traced slice: `trace_requests` whole requests under the
    profiler. Returns (per-layer metrics, device fields, answers,
    attempted, failed)."""
    cfg, n = cell.cfg, cell.tr["trace_requests"]
    say(f"traced slice: {n} whole requests of {cfg['segment_frames']} "
        "frames")
    cell.prog.stats.clear()
    (lat, _elapsed, answers, failed), kernels, ops, spans = profile(
        lambda: cell.run(None, n, mark=True))
    counters = dict(cell.prog.stats)
    say(f"counters over the slice: {json.dumps(counters)}")
    peaks = json.loads((spec.BENCH / "peaks.json").read_text())
    t = Trace(op=cell.op, frames=cfg["segment_frames"] * len(lat),
              frames_p=counters.get("decode_p" if cell.op == "decode"
                                    else "core_p", 0),
              geo=geometry.frame(cfg["width"], cfg["height"],
                                 cfg["subsamp"]),
              chips=len(cell.devices), kernels=kernels, ops=ops,
              spans=spans, counters=counters, peaks=peaks.get(kind))
    if not t.requests:
        return {}, {}, answers, n, failed
    metrics = {}
    for m in spec.metrics(bench, name, traced=True):
        v = spec.reader(m["name"])(t)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    t0, t1 = t.window
    window = (t1 - t0) * 1e-6
    busy = [t.busy(c) * 1e-6 for c in range(t.chips)]
    for c, b in enumerate(busy):
        say(f"card {c}: busy {b:.6f} s of {window:.6f} s, idle "
            f"{100 * (1 - b / window):.3f} %")
    device = {"busy_s": sum(busy) / len(busy), "window_s": window,
              "breakdown": breakdown(t)}
    return metrics, device, answers, n, failed


def timed(cell: Cell, bench: dict, name: str, seconds: int,
          setup_s: float, say) -> tuple:
    """The measured window. Returns (end-to-end metrics, answers,
    attempted, failed)."""
    lat, elapsed, answers, failed = cell.run(seconds, None)
    n_frames = cell.cfg["segment_frames"] * len(lat)
    values = {"setup_s": setup_s}
    if lat:
        fps = n_frames / elapsed
        tail = 1e3 * (p95(lat) if len(lat) > 1 else lat[0])
        values[f"{cell.op}_fps"] = fps
        values[f"{cell.op}_p95_ms"] = tail
        say(f"window {elapsed:.3f} s: {len(lat)} requests, {n_frames} "
            f"frames, {fps:.3f} frames/s; latency ms median "
            f"{1e3 * statistics.median(lat):.3f} p95 {tail:.3f} max "
            f"{1e3 * max(lat):.3f}")
        say("latencies ms: " + " ".join(f"{1e3 * x:.1f}" for x in lat))
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in spec.metrics(bench, name, traced=False)
               if m["name"] in values}
    return metrics, answers, len(lat) + failed, failed


def run(cell_name: str, seed: int, seconds: int, trace: bool,
        devices: list, t_start: float, cfg: dict | None = None,
        tr: dict | None = None, say=print):
    """A run of `cell_name` on `devices` (torch devices; several for a
    GOP mesh). cfg and tr stand in for the cell's configuration and
    traffic files where given. Returns the result line's object."""
    import torch
    bench = spec.load()
    w = spec.workload(bench, cell_name)
    cfg = cfg or spec.config(bench, w["config"])
    tr = tr or spec.traffic(w["traffic"])
    cuda = devices[0].type == "cuda"
    kind = torch.cuda.get_device_name(devices[0]) if cuda else "cpu"
    say(f"cards: {len(devices)} x {kind}")
    tmp = Path(tempfile.mkdtemp(prefix="dsv1bench-"))
    sampler = None
    try:
        cell = Cell(cfg, tr, seed, devices, tmp)
        for k in range(tr["pool"]):   # warm: each clip, the cell's shape
            cell.request(k)
        if cuda:
            for d in devices:
                torch.cuda.synchronize(d)
        gc.collect()
        gc.freeze()   # set-up's objects left out of the window's collections
        setup_s = time.perf_counter() - t_start
        say(f"setup {setup_s:.3f} s; pool {tr['pool']} clips of "
            f"{cfg['segment_frames']} frames {cfg['width']}x{cfg['height']}")
        sampler = Sampler() if cuda else None
        device = {}
        if trace:
            metrics, device, answers, attempted, failed = traced(
                cell, bench, cell_name, kind, say)
        else:
            metrics, answers, attempted, failed = timed(
                cell, bench, cell_name, seconds, setup_s, say)
        for line in (sampler.stop() if sampler else []):
            say(line)
        sampler = None
        refuse_jax()
        peak = (max(torch.cuda.max_memory_allocated(d) for d in devices)
                if cuda else 0)
        cell.prog = None
        if cuda:
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        nums = compare(cell, answers, devices[0])
        nums["failed_requests"] = failed
        say(f"reference: {len(answers)} answers compared in "
            f"{time.perf_counter() - t_ref:.3f} s")
        checks = {k: {"value": v, "limit": check.LIMITS[k]}
                  for k, v in nums.items()}
        correct = bool(answers) and all(
            c["value"] <= c["limit"] for c in checks.values())
        for k, c in checks.items():
            print(f"check {k} {c['value']} limit {c['limit']}",
                  file=sys.stderr)
        refuse_jax()
        out = {"correct": correct, "attempted": attempted,
               "failed": failed, "metrics": metrics,
               "device": {"platform": "gpu" if cuda else "cpu",
                          "kind": kind, "count": len(devices),
                          "memory_peak_bytes": peak}}
        if device:
            out["device"].update(busy_s=device["busy_s"],
                                 window_s=device["window_s"])
            out["breakdown"] = device["breakdown"]
        out["checks"] = checks
        return out
    finally:
        gc.unfreeze()
        if sampler is not None:
            sampler.stop()
        shutil.rmtree(tmp, ignore_errors=True)
