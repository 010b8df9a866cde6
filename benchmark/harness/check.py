"""What decides `correct`: the program's answers against a frozen plain
reference, run after the window on the same inputs. Every number
compared has the limit 0: the codec is integer exact, and its guarantee
is a stream and a decode that agree bit for bit with a conforming
codec's.

The reference that judges a configuration is the package directory
under reference/ that its file names under "reference": reference/dsvref
where it names none. A package exports ENTRIES and has a `cli` module
with `main`; the control also needs its `ops.sbt` rounding shifts.

The control (`control()`) is the reference with one guarantee broken:
its subband transforms' sign-symmetric rounding shifts (round2, round4,
round8 of the reference's sbt.c) taken as plain arithmetic shifts, the
cheaper rounding a faster transform would be tempted by."""

import contextlib
import importlib
from pathlib import Path

import numpy as np

from . import geometry
from .program import cli_args, encoder_config

ENTRIES = ("EncoderConfig", "Metadata", "quality_percent",
           "encode_stream_gops", "decode_stream_gops")

LIMITS = {"stream_diff_bytes": 0, "input_stream_diff_bytes": 0,
          "decoded_diff_samples": 0, "failed_requests": 0}


def diff_bytes(a: bytes, b: bytes) -> int:
    """Bytes that differ over the common length, plus the lengths'
    difference."""
    n = min(len(a), len(b))
    x = np.frombuffer(a, np.uint8, n)
    y = np.frombuffer(b, np.uint8, n)
    return int(np.count_nonzero(x != y)) + abs(len(a) - len(b))


def diff_frames(got: list, want: list) -> int:
    """Samples that differ between two decodes [(fno, [y, u, v])]: a
    frame missing, extra or out of order counts all its samples."""
    total = 0
    for k in range(max(len(got), len(want))):
        g = got[k] if k < len(got) else None
        w = want[k] if k < len(want) else None
        if g is None or w is None or g[0] != w[0]:
            total += sum(int(np.asarray(p).size)
                         for p in (g or w)[1])
            continue
        for pg, pw in zip(g[1], w[1]):
            pg, pw = np.asarray(pg), np.asarray(pw)
            total += (int(np.count_nonzero(pg != pw)) if pg.shape == pw.shape
                      else max(pg.size, pw.size))
    return total


def package(cfg: dict):
    """The reference package that judges configuration `cfg`, imported;
    raises ValueError naming the "reference" key and what is missing."""
    name = cfg.get("reference", "dsvref")
    where = geometry.REFERENCE / str(name)
    say = f'configuration {cfg.get("name")!r}: "reference": {name!r}'
    if not (isinstance(name, str) and name.isidentifier()
            and (where / "__init__.py").is_file()):
        raise ValueError(f"{say} names no package directory {where}")
    mod = geometry.reference(name)
    if Path(mod.__file__).resolve().parent != where.resolve():
        raise ValueError(f"{say} was imported from {mod.__file__}, not "
                         f"from {where}")
    missing = [e for e in ENTRIES if not hasattr(mod, e)]
    if not (where / "cli.py").is_file() or not callable(getattr(
            importlib.import_module(name + ".cli"), "main", None)):
        missing.append("cli.main")
    if missing:
        raise ValueError(f"{say} lacks {', '.join(missing)} in {where}")
    return mod


class Reference:
    """The configuration's frozen plain codec on one device (the cell's
    first)."""

    def __init__(self, cfg: dict, dev):
        self.ref = package(cfg)
        self.cli = self.ref.cli
        self.cfg, self.dev = cfg, dev
        self.meta = self.ref.Metadata(cfg["width"], cfg["height"],
                                      cfg["subsamp"])

    def encode(self, frames) -> bytes:
        return self.ref.encode_stream_gops(
            frames, self.meta, encoder_config(self.ref, self.cfg), self.dev)

    def cli_encode(self, inp: Path, out: Path) -> bytes:
        if self.cli.main(cli_args(self.cfg, inp, out), device=self.dev) != 0:
            raise RuntimeError("the reference CLI's encode returned non-zero")
        data = out.read_bytes()
        out.unlink()
        return data

    def decode(self, stream: bytes) -> list:
        return self.ref.decode_stream_gops(stream, self.dev)[1]


@contextlib.contextmanager
def control(cfg: dict | None = None):
    """The transforms of the reference that judges `cfg` (dsvref where
    none is given) with floor shifts in place of their sign-symmetric
    rounding shifts, for the duration."""
    sbt = importlib.import_module(package(cfg or {}).__name__ + ".ops.sbt")

    def floor_shift(add, shift):
        return lambda v: (v + add) >> shift
    saved = sbt.round2, sbt.round4, sbt.round8
    sbt.round2, sbt.round4, sbt.round8 = (floor_shift(1, 1),
                                          floor_shift(2, 2),
                                          floor_shift(4, 3))
    try:
        yield
    finally:
        sbt.round2, sbt.round4, sbt.round8 = saved
