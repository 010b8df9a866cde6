"""The arithmetic the per-layer readers (metrics/*.py) share. Each
returns None where the slice has nothing to read."""

from . import spec
from .trace import Trace, clip, union

PROGRAM_SPANS = "gop."


def span_ms_per_frame(t: Trace, op: str, name: str, less: str = ""):
    """Milliseconds a frame of host time in the program's `name` spans
    (less the `less` spans, which lie inside them)."""
    total = t.span_total(name)
    if t.op != op or not t.frames or not total:
        return None
    return (total - (t.span_total(less) if less else 0.0)) * 1e-3 / t.frames


def unspanned_ms_per_frame(t: Trace, op: str):
    """Milliseconds a frame of the benchmark's request spans that no
    span of the program covers."""
    if t.op != op or not t.frames:
        return None
    prog = [(a, b) for n, a, b in t.spans if n.startswith(PROGRAM_SPANS)]
    total = sum((b - a) - union(clip(prog, a, b)) for a, b in t.requests)
    return total * 1e-3 / t.frames


def kernels_per_frame(t: Trace, op: str):
    if t.op != op or not t.frames:
        return None
    return t.kernel_count() / t.frames


def roofline(t: Trace, op: str, families):
    """Percent: the least time of the families' bytes at the card's
    published bandwidth (each family's bytes a frame, by frame type,
    from the frame geometry and the slice's P and I frame counts), over
    the time in which any kernel ran, per card and summed over cards."""
    if t.op != op or not t.frames or not t.peaks:
        return None
    n_i = t.frames - t.frames_p
    nbytes = 0
    for fam in families:
        f = spec.work(fam)
        nbytes += f(t.geo, True) * t.frames_p + f(t.geo, False) * n_i
    device_us = sum(t.kernel_time(c) for c in t.kernels)
    if not device_us:
        return None
    return 100.0 * (nbytes / t.peaks["hbm_bytes_per_s"]) / (device_us * 1e-6)


def idle_share(t: Trace, op: str):
    """Percent of the slice in which no device operation ran, the mean
    over the cards the cell uses."""
    if t.op != op or not t.frames:
        return None
    t0, t1 = t.window
    busy = [t.busy(c) for c in range(t.chips)]
    return 100.0 * (1.0 - sum(busy) / len(busy) / (t1 - t0))
