"""A configuration's "reference" key: the package directory under
reference/ that judges it, dsvref where the key is absent. Each test
writes its own packages into a reference/ of its own; a run of a cell
on the CPU is then judged by the package named."""

import importlib
import shutil
import sys

import pytest

import helpers
from harness import cell, check, geometry
from harness.spec import BENCH

DSVREF = BENCH / "reference" / "dsvref"

# A package that answers as dsvref does, except where FLIP says: the last
# byte of the GOP encode's stream, of the CLI's output file, or the first
# luma sample of the decode's first frame altered where it is produced.
FLIP_INIT = '''
import numpy as np

import dsvref
from dsvref import (EncoderConfig, Metadata, quality_percent,
                    decode_stream_gops, encode_stream_gops)

FLIP = {flip!r}

if FLIP == "encode_stream_gops":
    def encode_stream_gops(*a, **k):
        s = bytearray(dsvref.encode_stream_gops(*a, **k))
        s[-1] ^= 0x5A
        return bytes(s)

if FLIP == "decode_stream_gops":
    def decode_stream_gops(*a, **k):
        meta, frames = dsvref.decode_stream_gops(*a, **k)
        fno, planes = frames[0]
        y = np.array(planes[0])
        y[0, 0] ^= 1
        frames[0] = (fno, [y, *planes[1:]])
        return meta, frames
'''
FLIP_CLI = '''
from pathlib import Path

from dsvref import cli

from . import FLIP


def main(argv, device="cuda"):
    rc = cli.main(argv, device=device)
    if FLIP == "cli.main":
        out = Path(next(a[len("-out_"):] for a in argv
                        if a.startswith("-out_")))
        s = bytearray(out.read_bytes())
        s[-1] ^= 0x5A
        out.write_bytes(bytes(s))
    return rc
'''


@pytest.fixture
def refdir(tmp_path, monkeypatch):
    """A reference/ of the test's own (laid out as in a checkout, so a
    copy of dsvref builds its native library under tmp_path); the
    packages written there are unloaded afterwards."""
    root = tmp_path / "benchmark" / "reference"
    root.mkdir(parents=True)
    monkeypatch.setattr(geometry, "REFERENCE", root)
    monkeypatch.setattr(sys, "path", list(sys.path))
    names = set()

    def write(name: str, files: dict):
        for rel, text in files.items():
            (root / name / rel).parent.mkdir(parents=True, exist_ok=True)
            (root / name / rel).write_text(text)
        names.add(name)
        importlib.invalidate_caches()
        return root / name
    write.root = root
    write.names = names
    yield write
    for m in [m for m in sys.modules if m.split(".")[0] in names]:
        del sys.modules[m]


def copy_dsvref(refdir, name: str):
    """A whole copy of dsvref under another name: every import inside it
    is relative, so it loads as a package of its own."""
    shutil.copytree(DSVREF, refdir.root / name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    refdir.names.add(name)
    importlib.invalidate_caches()


def test_naming_dsvref_reads_what_naming_nothing_reads():
    assert check.package({"reference": "dsvref"}) is check.package({})
    assert check.package({}) is sys.modules["dsvref"]
    plain = helpers.run_small("crf_1080p.encode")
    named = helpers.run_small("crf_1080p.encode",
                              cfg_keys={"reference": "dsvref"})
    assert plain["correct"] and named["correct"]
    for k in ("correct", "attempted", "failed", "checks"):
        assert named[k] == plain[k], k


FLIPS = [("crf_1080p.encode", "encode_stream_gops", "stream_diff_bytes"),
         ("abr_4k_cli.encode", "cli.main", "stream_diff_bytes"),
         ("crf_1080p.decode", "decode_stream_gops", "decoded_diff_samples")]


@pytest.mark.parametrize("name,flip,key", FLIPS,
                         ids=[f for _c, f, _k in FLIPS])
def test_the_named_package_judges_the_cell(refdir, name, flip, key):
    """A package whose answer differs from dsvref's in one byte or one
    sample fails a sound run of the program: the check reads it."""
    pkg = "flip_" + flip.replace(".", "_")
    refdir(pkg, {"__init__.py": FLIP_INIT.format(flip=flip),
                 "cli.py": FLIP_CLI})
    out = helpers.run_small(name, cfg_keys={"reference": pkg})
    assert not out["correct"], out["checks"]
    assert out["checks"][key]["value"] >= 1
    assert out["failed"] == 0
    assert sys.modules[pkg].__file__.startswith(str(refdir.root))


def test_a_copy_of_dsvref_judges_alike(refdir):
    """A configuration naming a whole copy of dsvref is judged by the copy
    (its own modules) and reads correct."""
    copy_dsvref(refdir, "refcopy")
    out = helpers.run_small("crf_1080p.encode",
                            cfg_keys={"reference": "refcopy"})
    assert out["correct"], out["checks"]
    assert sys.modules["refcopy.ops.sbt"] is not sys.modules[
        "dsvref.ops.sbt"]


CLI_STUB = "def main(argv, device='cuda'):\n    return 1\n"
BAD = {
    "unknown": ("no_such_ref", {}, "names no package directory"),
    "a_path": ("../reference/dsvref", {}, "names no package directory"),
    "not_a_package": ("bare", {"cli.py": CLI_STUB},
                      "names no package directory"),
    "an_entry_missing": ("noentry", {"__init__.py": "from dsvref import "
                                     "EncoderConfig, Metadata\n",
                                     "cli.py": CLI_STUB},
                         "quality_percent, encode_stream_gops, "
                         "decode_stream_gops"),
    "no_cli": ("nocli", {"__init__.py": FLIP_INIT.format(flip="")},
               "lacks cli.main"),
}


@pytest.mark.parametrize("case", list(BAD))
def test_a_bad_reference_raises_before_any_request(refdir, case,
                                                   monkeypatch):
    name, files, says = BAD[case]
    if files:
        refdir(name, files)
    made = []
    monkeypatch.setattr(cell, "Program", lambda *a: made.append(a))
    monkeypatch.setattr(cell.traffic, "pool",
                        lambda *a: made.append(a) or [])
    with pytest.raises(ValueError, match='"reference"') as e:
        helpers.run_small("crf_1080p.encode", cfg_keys={"reference": name})
    assert says in str(e.value)
    assert not made


def test_control_breaks_the_named_package_and_restores_it(refdir):
    """check.control() on a configuration replaces the rounding shifts of
    the package that judges it, not dsvref's, and puts them back."""
    import torch
    from harness import corpus
    copy_dsvref(refdir, "ctlref")
    w, h, n = 96, 80, 13
    cfg = {"name": "t", "reference": "ctlref", "width": w, "height": h,
           "subsamp": 5, "gop": 12, "quality_pct": 85, "effort": 0}
    torch.set_num_threads(2)
    ref = check.Reference(cfg, torch.device("cpu"))
    frames = corpus.split_frames(
        corpus.make_rich_clip(w, h, 5, n, seed=2**33 + 9), w, h, 5, n)
    want = ref.encode(frames)
    sbt = sys.modules["ctlref.ops.sbt"]
    kept = sbt.round2, sbt.round4, sbt.round8
    own = sys.modules["dsvref.ops.sbt"].round2
    with check.control(cfg):
        assert sbt.round2 is not kept[0]
        assert sys.modules["dsvref.ops.sbt"].round2 is own
        got = ref.encode(frames)
    assert check.diff_bytes(got, want) > 0
    assert (sbt.round2, sbt.round4, sbt.round8) == kept
    assert check.diff_bytes(ref.encode(frames), want) == 0
