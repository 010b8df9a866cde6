"""A frame's geometry from its size and format, as the frozen reference
(reference/dsvref) computes it: what the roofline's bytes functions
(work/*.py) read. Also the loader of the plain reference packages under
reference/, one of which judges each configuration (check.py)."""

import importlib
import sys

from .spec import BENCH

REFERENCE = BENCH / "reference"


def reference(name: str):
    """The plain reference package `name` (reference/<name>/), imported
    with reference/ on the path."""
    path = str(REFERENCE)
    if path not in sys.path:
        sys.path.insert(0, path)
    return importlib.import_module(name)


def dsvref():
    """The frozen reference package (reference/dsvref)."""
    return reference("dsvref")


def frame(w: int, h: int, subsamp: int) -> dict:
    """{planes: [(w, h, ext)], dims: [(cw, ch)] coefficient arrays,
    n: [traversal values a plane], blocks: motion blocks a frame}."""
    dsvref()
    from dsvref.models.encoder import block_geometry, coef_geometry
    _bw, _bh, nbh, nbv = block_geometry(w, h)
    layout, dims, tables = coef_geometry(subsamp, w, h, nbh, nbv)
    return {"planes": [(p.w, p.h, p.ext) for p in layout.planes],
            "dims": list(dims), "n": [t.n for t in tables],
            "blocks": nbh * nbv}
