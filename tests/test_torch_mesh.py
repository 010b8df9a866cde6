"""PyTorch port vs JAX: GOP meshes (`gop_mesh`, the `mesh=` arguments).

The port's mesh is `["cpu"] * k` (a device listed k times), the JAX
package's the first k of the 8 virtual CPU devices (tests/conftest.py):

- `encode_stream_gops(mesh=...)` at k = 2 and 3 against the JAX
  package's stream: GOPs split contiguously over the mesh at one GOP a
  device, stable_refresh not dividing gop - 1 (GOPs start from a
  stability state carried across a device boundary), a scene cut, a
  padded tail chunk; 4:2:2 and GOP-granular ABR (one quality a chunk)
  are `slow`;
- the JAX package's ValueErrors: per-frame ABR with a mesh, a 'tile'
  axis without a 'gop' axis;
- `decode_stream_gops(mesh=...)` against the JAX package's decoded
  planes over its mesh;
- `encode_stream_multihost(mesh=...)`; gop 0 over a mesh;
- the kernel wrappers' device guard: every C call runs with its
  tensor's device current (checked with a spy: nothing launches here).
"""

import re
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from dsv1_tpu.constants import (RATE_CONTROL_ABR, RATE_CONTROL_CRF,
                                SUBSAMP_420, SUBSAMP_422, quality_percent)
from dsv1_tpu.models.encoder import EncoderConfig
from dsv1_tpu.models.metadata import Metadata
from dsv1_tpu.parallel import (decode_stream_gops, encode_stream_gops,
                               gop_mesh)
from dsv1_tpu.parallel.tile import tile_mesh
import dsv1_tpu_torch as dt
from dsv1_tpu_torch.kernels import build as kb

from . import corpus
from .test_torch_decode import _with_cut

torch.set_num_threads(1)

W, H, G = 96, 80, 4


def _cfgs(abr=False, **kw):
    base = dict(gop=G, stable_refresh=2, **kw)
    if abr:
        base.update(rc_mode=RATE_CONTROL_ABR, bitrate=60_000)
    else:
        base.update(rc_mode=RATE_CONTROL_CRF, quality=quality_percent(85))
    return EncoderConfig(**base), dt.EncoderConfig(**base)


def _frames(subsamp=SUBSAMP_420, n=23, cut=9):
    return _with_cut(corpus.make_clip_frames(W, H, subsamp, n, seed=4), cut)


_STREAMS = {}


def _jax_stream(k, subsamp=SUBSAMP_420, abr=False):
    """The JAX package's stream over its k-device mesh (one compile per
    case, shared by the tests of this file)."""
    key = (k, subsamp, abr)
    if key not in _STREAMS:
        jcfg, _ = _cfgs(abr)
        _STREAMS[key] = encode_stream_gops(
            _frames(subsamp), Metadata(W, H, subsamp), jcfg,
            mesh=gop_mesh(jax.devices()[:k]), gops_per_device=1,
            abr_mode="gop")
    return _STREAMS[key]


@pytest.mark.parametrize("k,subsamp,abr", [
    (2, SUBSAMP_420, False), (3, SUBSAMP_420, False),
    pytest.param(2, SUBSAMP_422, False, marks=pytest.mark.slow),
    pytest.param(2, SUBSAMP_420, True, marks=pytest.mark.slow),
])
def test_mesh_encode_matches_jax(k, subsamp, abr):
    """23 frames at gop 4: six GOPs, the last of 3 frames, in chunks of
    k GOPs (the tail chunk padded), a cut at frame 9, refresh every 2 P
    frames (GOPs 1, 3 and 5 start from carried states)."""
    _, tcfg = _cfgs(abr)
    got = dt.encode_stream_gops(_frames(subsamp), dt.Metadata(W, H, subsamp),
                                tcfg, mesh=dt.gop_mesh(["cpu"] * k),
                                gops_per_device=1, abr_mode="gop")
    assert got == _jax_stream(k, subsamp, abr)


def test_mesh_decode_matches_jax():
    stream = _jax_stream(2)
    _jm, want = decode_stream_gops(stream, gop_mesh(jax.devices()[:2]))
    _tm, got = dt.decode_stream_gops(stream, mesh=dt.gop_mesh(["cpu"] * 2))
    assert [f for f, _ in got] == [f for f, _ in want]
    for (_, gp), (_, wp) in zip(got, want):
        for a, b in zip(gp, wp):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_multihost_over_a_mesh():
    """Two shards, each over a 2-device mesh: the JAX mesh stream."""
    _, tcfg = _cfgs()
    got = dt.encode_stream_multihost(_frames(), dt.Metadata(W, H,
                                                            SUBSAMP_420),
                                     tcfg, n_shards=2,
                                     mesh=dt.gop_mesh(["cpu"] * 2))
    assert got == _jax_stream(2)


def test_gop0_over_a_mesh_matches_jax():
    """gop 0 (intra only) ignores the mesh, as the JAX package's intra
    path does: the stream of one device."""
    frames = _frames(n=5)
    kw = dict(gop=0, rc_mode=RATE_CONTROL_CRF, quality=quality_percent(85))
    want = encode_stream_gops(frames, Metadata(W, H, SUBSAMP_420),
                              EncoderConfig(**kw),
                              mesh=gop_mesh(jax.devices()[:2]))
    got = dt.encode_stream_gops(frames, dt.Metadata(W, H, SUBSAMP_420),
                                dt.EncoderConfig(**kw),
                                mesh=dt.gop_mesh(["cpu"] * 2))
    assert got == want


def _raises(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_mesh_value_errors_match_jax():
    frames = _frames(n=8)
    jm, tm = Metadata(W, H, SUBSAMP_420), dt.Metadata(W, H, SUBSAMP_420)
    jcfg, tcfg = _cfgs(abr=True)
    assert _raises(lambda: dt.encode_stream_gops(
        frames, tm, tcfg, mesh=dt.gop_mesh(["cpu"] * 2))) == _raises(
        lambda: encode_stream_gops(frames, jm, jcfg,
                                   mesh=gop_mesh(jax.devices()[:2])))
    jcfg, tcfg = _cfgs()
    assert _raises(lambda: dt.encode_stream_gops(
        frames, tm, tcfg, mesh=dt.tile_mesh(["cpu"] * 2))) == _raises(
        lambda: encode_stream_gops(frames, jm, jcfg,
                                   mesh=tile_mesh(jax.devices()[:2])))


def test_kernel_launch_makes_the_tensor_device_current(monkeypatch):
    """`kernels.build.launch` makes the tensor's device current around
    the C call and passes that device's stream; every kernel wrapper
    calls its entry point through it."""
    seen = []

    class Spy:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            seen.append(("enter", self.device))

        def __exit__(self, *exc):
            seen.append(("exit", self.device))

    def entry(*args):
        seen.append(("call", args))
        return 0

    monkeypatch.setattr(torch.cuda, "device", Spy)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: SimpleNamespace(cuda_stream=1000 + d.index))
    monkeypatch.setattr(kb, "lib", lambda: SimpleNamespace(dsv1_x=entry))
    t = SimpleNamespace(device=torch.device("cuda", 1))
    kb.launch("dsv1_x", t, 7, 8)
    assert seen == [("enter", t.device), ("call", (7, 8, 1001)),
                    ("exit", t.device)]
    monkeypatch.setattr(kb, "lib", lambda: SimpleNamespace(
        dsv1_x=lambda *a: 700))
    with pytest.raises(RuntimeError, match="dsv1_x failed"):
        kb.launch("dsv1_x", t)
    ops = Path(kb.__file__).resolve().parents[1] / "ops"
    src = "".join(p.read_text() for p in ops.glob("*.py"))
    assert "lib()." not in src
    entries = re.findall(r'launch\("(dsv1_\w+)"', src)
    assert sorted(entries) == sorted(
        ["dsv1_mc_frame", "dsv1_hme_refine", "dsv1_hme_coarse",
         "dsv1_hme_base", "dsv1_hme_wide", "dsv1_haar_pyramid"])
