"""The arithmetic of the readers (metrics/*.py) of the program's host
spans of intake, reads, file I/O and decode steps, and of its read and
overflow counters. Each returns None where the slice has nothing to
read: a program without those spans or counters reads nothing."""

from .trace import REQUEST, Trace, clip, union


def spans_ms_per_frame(t: Trace, op: str, *names: str):
    """Milliseconds a frame of host time under any of the program's
    `names` spans (the union of their intervals, so a span inside
    another counts once)."""
    if t.op != op or not t.frames:
        return None
    spans = [(a, b) for n, a, b in t.spans if n in names]
    if not spans:
        return None
    return union(spans) * 1e-3 / t.frames


def unattributed_ms_per_frame(t: Trace, op: str):
    """Milliseconds a frame of the benchmark's request spans that no span
    of the program covers, whatever its name."""
    if t.op != op or not t.frames or not t.requests:
        return None
    prog = [(a, b) for n, a, b in t.spans if n != REQUEST]
    total = sum((b - a) - union(clip(prog, a, b)) for a, b in t.requests)
    return total * 1e-3 / t.frames


def counter_per_frame(t: Trace, op: str, key: str, scale: float = 1.0):
    """The program's counter `key` over the slice, times `scale`, per
    frame."""
    if t.op != op or not t.frames or key not in t.counters:
        return None
    return t.counters[key] * scale / t.frames


def counter_share(t: Trace, op: str, key: str, of: str):
    """Percent: the counter `key` over the counter `of`."""
    if t.op != op or not t.frames or key not in t.counters \
            or not t.counters.get(of):
        return None
    return 100.0 * t.counters[key] / t.counters[of]
