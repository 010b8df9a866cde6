"""BENCHMARK.json and the files it names: a cell's configuration, its
traffic mix, and the metrics it reports."""

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def workload(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(spec: dict, name: str) -> dict:
    """A configuration's file (its settings, as run)."""
    for c in spec["configs"]:
        if c["name"] == name:
            return json.loads((ROOT / c["file"]).read_text())
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    """A traffic mix's parameters, `traffic/<name>.json`."""
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def metrics(spec: dict, cell: str, traced: bool) -> list:
    """The metrics a run of `cell` reports: its per-layer metrics when
    traced, else its end-to-end ones (those without a `workloads` key
    apply to every cell)."""
    group = spec["per_layer" if traced else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def _load(path: Path):
    mod = importlib.util.spec_from_file_location(
        "bench_" + path.stem.replace(".", "_"), path)
    m = importlib.util.module_from_spec(mod)
    mod.loader.exec_module(m)
    return m


def reader(name: str):
    """The per-layer metric `name`'s reader: `metrics/<name>.py`, whose
    `read(trace)` gives the value or None."""
    return _load(BENCH / "metrics" / f"{name}.py").read


def work(family: str):
    """A roofline work family's bytes function: `work/<family>.py`,
    `nbytes(geo, is_p)` for one frame."""
    return _load(BENCH / "work" / f"{family}.py").nbytes
