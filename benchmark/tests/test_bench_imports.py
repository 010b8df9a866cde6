"""The import check: a short cell's code path on the CPU, in a process of
its own, leaves no module whose top-level name is JAX's or the JAX
package's (compared whole: the port's name begins with the JAX
package's), and the reference loads nothing of the program."""

import json
import subprocess
import sys

from harness.spec import BENCH

SCRIPT = r"""
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2], sys.argv[3]]
import helpers
out = helpers.run_small("crf_1080p.encode")
ref = sorted(m for m in sys.modules if m.split(".")[0] == "dsvref")
print(json.dumps({"correct": out["correct"],
                  "roots": sorted({m.split(".")[0] for m in sys.modules}),
                  "ref": ref}))
"""

REF_ONLY = r"""
import json, sys
sys.path[:0] = [sys.argv[1]]
import torch
import dsvref
from dsvref import cli
meta = dsvref.Metadata(64, 48, 5)
cfg = dsvref.EncoderConfig(quality=dsvref.quality_percent(85), gop=12)
import numpy as np
frames = [(np.full((48, 64), 100, np.uint8), np.full((24, 32), 128, np.uint8),
           np.full((24, 32), 128, np.uint8))] * 3
s = dsvref.encode_stream_gops(frames, meta, cfg, "cpu")
dsvref.decode_stream_gops(s, "cpu")
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_cell_code_path_loads_no_jax():
    r = subprocess.run([sys.executable, "-c", SCRIPT, str(BENCH.parent),
                        str(BENCH), str(BENCH / "tests")],
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"]
    assert not set(out["roots"]) & {"jax", "jaxlib", "flax", "dsv1_tpu"}
    assert "dsv1_tpu_torch" in out["roots"] and out["ref"]


def test_reference_loads_nothing_of_the_program():
    r = subprocess.run([sys.executable, "-c", REF_ONLY,
                        str(BENCH / "reference")], capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    roots = set(json.loads(r.stdout.strip().splitlines()[-1]))
    assert not roots & {"dsv1_tpu_torch", "dsv1_tpu", "jax", "jaxlib",
                        "flax"}
