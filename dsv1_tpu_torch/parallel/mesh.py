"""Device meshes (the port's counterpart of `jax.sharding.Mesh`).

A `Mesh` holds torch devices in an array shaped by its named axes: the
GOP axis (`gop_mesh`, parallel/gop.py and parallel/decode.py split GOPs
and chains over it), the tile axis (`tile_mesh`, parallel/tile.py splits
a frame's columns over it) or both (`gop_tile_mesh`). There is no
partitioner behind it: the paths that take a mesh place each piece of
work on its device themselves. A device may be listed more than once
(`["cpu"] * 4`, or `["cuda:0"] * 2` on one card): each entry is then its
own member of the mesh, and the entries share the device's work queue.
"""

import numpy as np
import torch

from ..device import resolve


class Mesh:
    """devices: an ndarray of torch.device shaped by the axes;
    axis_names: the axes' names; shape: {axis name: size}, as in JAX."""

    def __init__(self, devices, axis_names):
        devs = [resolve(d) for d in np.asarray(devices, dtype=object)
                .reshape(-1)]
        if not devs:
            raise ValueError("a mesh needs at least one device")
        arr = np.empty(len(devs), dtype=object)
        arr[:] = devs
        self.axis_names = tuple(axis_names)
        self.devices = arr.reshape(np.shape(np.asarray(devices,
                                                       dtype=object)))
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"devices of shape {self.devices.shape} for "
                             f"axes {self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))


def _device_list(devices) -> list:
    """The devices given, or every visible CUDA device; raises where none
    is asked for and none is visible (no CPU pick)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible; pass the mesh's "
                               "devices (e.g. ['cpu'] * k)")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [resolve(d) for d in devices]


def gop_mesh(devices=None, axis: str = "gop") -> Mesh:
    """1-D mesh over the GOP axis (the JAX package's gop_mesh,
    dsv1_tpu/parallel/gop.py:872): each device encodes or decodes its
    own GOPs, with no communication on the frame path."""
    return Mesh(_device_list(devices), (axis,))


def tile_mesh(devices=None, axis: str = "tile") -> Mesh:
    """1-D mesh over the intra-frame tile axis (the JAX package's
    tile_mesh, dsv1_tpu/parallel/tile.py:41)."""
    return Mesh(_device_list(devices), (axis,))


def gop_tile_mesh(n_gop: int, n_tile: int, devices=None) -> Mesh:
    """2-D (gop x tile) mesh (dsv1_tpu/parallel/gop.py:879): GOPs split
    over 'gop', each GOP's subband transforms split into column tiles
    over 'tile'. Takes the first n_gop * n_tile devices; raises where
    there are fewer."""
    devs = _device_list(devices)
    if n_gop * n_tile > len(devs):
        raise ValueError(f"need {n_gop * n_tile} devices, have {len(devs)}")
    arr = np.empty(n_gop * n_tile, dtype=object)
    arr[:] = devs[:n_gop * n_tile]
    return Mesh(arr.reshape(n_gop, n_tile), ("gop", "tile"))


def gop_rows(mesh: Mesh) -> list:
    """The mesh's GOP rows, in order: per index of the 'gop' axis the
    list of its devices (one device on a 1-D GOP mesh, the row's tile
    devices on a gop x tile mesh)."""
    if "gop" not in mesh.axis_names or mesh.devices.ndim == 1:
        return [[d] for d in mesh.devices.reshape(-1)]
    a = np.moveaxis(mesh.devices, mesh.axis_names.index("gop"), 0)
    return [list(r.reshape(-1)) for r in a]
