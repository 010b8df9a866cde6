"""The frozen reference (reference/dsvref) on a tiny stream: it agrees
with the program byte for byte and sample for sample, it imports
nothing of the program, and its control differs from it."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from harness import check, corpus
from harness.spec import BENCH

W, H, N = 96, 80, 13
CFG = {"width": W, "height": H, "subsamp": 5, "gop": 12, "quality_pct": 85,
       "effort": 0, "api": "gop", "cli_args": [f"-w{W}", f"-h{H}"]}


@pytest.fixture(scope="module")
def clip():
    return corpus.make_rich_clip(W, H, 5, N, seed=2**33 + 5)


@pytest.fixture(scope="module")
def ref():
    torch.set_num_threads(2)
    return check.Reference(CFG, torch.device("cpu"))


def test_reference_matches_the_program(clip, ref):
    import dsv1_tpu_torch as dt
    frames = corpus.split_frames(clip, W, H, 5, N)
    cfg = dt.EncoderConfig(quality=dt.quality_percent(85), gop=12)
    got = dt.encode_stream_gops(frames, dt.Metadata(W, H, 5), cfg, "cpu")
    want = ref.encode(frames)
    assert check.diff_bytes(got, want) == 0
    dec = dt.decode_stream_gops(got, "cpu")[1]
    assert len(dec) == N
    assert check.diff_frames(dec, ref.decode(want)) == 0


def test_reference_cli_matches_the_program(clip, ref, tmp_path):
    from dsv1_tpu_torch import cli
    inp = tmp_path / "in.yuv"
    inp.write_bytes(clip)
    out = tmp_path / "out.dsv"
    assert cli.main(["e", f"-inp_{inp}", f"-out_{out}", f"-w{W}", f"-h{H}",
                     "-y"], device="cpu") == 0
    assert check.diff_bytes(out.read_bytes(),
                            ref.cli_encode(inp, tmp_path / "r.dsv")) == 0


def test_control_breaks_the_guarantee(clip, ref):
    """The control, at a size a test run holds: its stream and its decode
    differ from the reference's."""
    frames = corpus.split_frames(clip, W, H, 5, N)
    want = ref.encode(frames)
    truth = ref.decode(want)
    with check.control():
        got = ref.encode(frames)
        dec = ref.decode(want)
    assert check.diff_bytes(got, want) > 0
    assert check.diff_frames(dec, truth) > 0
    assert check.diff_bytes(ref.encode(frames), want) == 0   # restored


def test_diffs():
    assert check.diff_bytes(b"abcd", b"abcd") == 0
    assert check.diff_bytes(b"abcd", b"abXd") == 1
    assert check.diff_bytes(b"abcd", b"ab") == 2
    f = [(0, [np.zeros((2, 2), np.uint8)] * 3)]
    g = [(0, [np.ones((2, 2), np.uint8)] + [np.zeros((2, 2), np.uint8)] * 2)]
    assert check.diff_frames(f, f) == 0
    assert check.diff_frames(g, f) == 4
    assert check.diff_frames([], f) == 12
    assert check.diff_frames([(1, f[0][1])], f) == 12


def imported_roots(path: Path) -> set:
    roots = set()
    for n in ast.walk(ast.parse(path.read_text())):
        if isinstance(n, ast.Import):
            roots |= {a.name.split(".")[0] for a in n.names}
        elif isinstance(n, ast.ImportFrom) and n.level == 0:
            roots.add(n.module.split(".")[0])
    return roots


def test_reference_imports_nothing_of_the_program():
    files = sorted((BENCH / "reference").rglob("*.py"))
    assert files
    for f in files:
        bad = imported_roots(f) & {"dsv1_tpu_torch", "dsv1_tpu", "jax",
                                   "jaxlib", "flax"}
        assert not bad, f"{f}: {bad}"


def bound_names(path: Path) -> set:
    """Names a module binds at its top level: imports, definitions,
    assignments, and the strings of its `__all__`."""
    names = set()
    for n in ast.parse(path.read_text()).body:
        if isinstance(n, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in n.names}
        elif isinstance(n, (ast.FunctionDef, ast.ClassDef)):
            names.add(n.name)
        elif isinstance(n, ast.Assign):
            for t in n.targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
                    if t.id == "__all__":
                        names |= set(ast.literal_eval(n.value))
    return names


def test_every_reference_package_exports_what_the_check_reads():
    """Each package directory under reference/ (one a configuration can
    name under "reference") exports what check.Reference reads, has a
    CLI with `main`, and the rounding shifts the control replaces."""
    dirs = [d for d in sorted((BENCH / "reference").iterdir())
            if d.is_dir() and d.name != "__pycache__"]
    assert "dsvref" in [d.name for d in dirs]
    for d in dirs:
        init = d / "__init__.py"
        assert init.is_file(), d
        exported = bound_names(init)
        assert set(check.ENTRIES) <= exported, (d, exported)
        assert "main" in bound_names(d / "cli.py"), d
        assert {"round2", "round4", "round8"} <= bound_names(
            d / "ops" / "sbt.py"), d


def test_only_program_py_imports_the_program():
    for f in sorted(BENCH.rglob("*.py")):
        if "tests" in f.parts or f.name == "program.py":
            continue
        roots = imported_roots(f)
        assert not roots & {"jax", "jaxlib", "flax", "dsv1_tpu"}, f
        assert "dsv1_tpu_torch" not in roots, f
