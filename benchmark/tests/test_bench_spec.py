"""BENCHMARK.json against the benchmark's contract, and every file it
names found by that name."""

import json
import re

import pytest

from harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = ["crf_1080p.encode", "abr_4k_cli.encode", "crf_1080p.decode"]
E2E = ["encode_fps", "encode_p95_ms", "decode_fps", "decode_p95_ms",
       "setup_s"]
PER_LAYER = ["gop.recon_chain_ms", "gop.pack_ms", "gop.motion_ms",
             "gop.rate_read_ms", "encode.unspanned_ms", "overflow_share",
             "kernels_per_frame.encode", "roofline.encode",
             "device_idle.encode", "kernels_per_frame.decode",
             "roofline.decode", "device_idle.decode"]

BENCH = spec.load()


def line_ok(s: str, n: int = 200) -> bool:
    return 1 <= len(s) <= n and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert (spec.ROOT / BENCH["command"][1]).is_file()


def test_run_seconds_fit_a_check_of_24_cells():
    t = BENCH["run_seconds"]
    assert 1 <= t <= 51
    assert (2 + 14 * 24) * (t + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_letter_for_letter():
    """PR 14's names stay first, in order and letter for letter; later
    names only append."""
    for key, first in (("workloads", CELLS), ("end_to_end", E2E),
                       ("per_layer", PER_LAYER),
                       ("configs", ["crf_1080p", "abr_4k_cli"])):
        assert [x["name"] for x in BENCH[key]][:len(first)] == first, key


def test_names_units_and_lines():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for x in BENCH["configs"] + BENCH["workloads"]:
        assert line_ok(x["why"])
    for c in BENCH["configs"]:
        assert line_ok(c["source"]) and c["source"].startswith("https://")
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for m in BENCH["per_layer"]:
        assert line_ok(m["layer"])


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert c["file"].startswith("benchmark/configs/")
    cfg = json.loads((spec.ROOT / c["file"]).read_text())
    assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    assert all(k in cfg for k in c["reduced"])
    for k in ("width", "height", "subsamp", "gop", "segment_frames",
              "api", "chips", "guarantee"):
        assert k in cfg
    ref = cfg.get("reference", "dsvref")   # the package that judges it
    assert ref.isidentifier()
    assert (spec.BENCH / "reference" / ref).is_dir()
    files = [x["file"] for x in BENCH["configs"]]
    assert len(files) == len(set(files))


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_workloads_and_traffic(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    cfg = spec.config(BENCH, w["config"])
    tr = spec.traffic(w["traffic"])
    assert NAME.match(w["traffic"])
    assert cfg["chips"] == w["chips"] and w["chips"] in (1, 4)
    assert tr["op"] in ("encode", "decode") and tr["pool"] >= 1
    assert tr["trace_requests"] >= 1
    e2e = {m["name"] for m in spec.metrics(BENCH, w["name"], False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.metrics(BENCH, w["name"], True)


def test_cells_on_one_chip_pairs_once_configs_used():
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_end_to_end_bounds():
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in BENCH["end_to_end"])


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_has_a_reader(m):
    assert set(m) == {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"}
    assert m["source"] in ("device_trace", "program_span", "program_counter",
                           "host_clock")
    assert callable(spec.reader(m["name"]))
    moves = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
    for cell in m["workloads"]:
        assert cell in moves.get("workloads", [cell])


def test_layers_named_alike():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("family", ["mc", "haar", "residual_in", "b4t_fwd",
                                    "hzcc_quant", "hzcc_dequant", "inv_sbt"])
def test_work_families(family):
    from harness.geometry import frame
    geo = frame(1920, 1080, 5)
    f = spec.work(family)
    assert f(geo, True) + f(geo, False) > 0
    assert f(geo, True) >= 0 and f(geo, False) >= 0
