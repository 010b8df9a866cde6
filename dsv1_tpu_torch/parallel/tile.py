"""Subband column tiles: intra-frame parallelism for large frames (mirror
of dsv1_tpu/parallel/tile.py).

A frame's coefficient array is split into D even column tiles over the
devices of a 'tile' mesh axis, as the JAX package lays it out with
`NamedSharding(mesh, P(None, "tile"))`: tile k holds the global columns
[k W/D, (k+1) W/D) on device k (`split_tiles`; `join_tiles` puts them
back together). The JAX package jits the unsplit transforms and lets
XLA's partitioner insert the halo exchanges and the coarse-level
gathers; the port has no partitioner, so it does them by hand, with the
same split of the work:

- Levels before `_replicate_level` run per tile. The Haar transform is
  2x2-local and each level halves the carried region, so tile k's LL
  after level l is exactly the global LL columns [k W/(D 2^l),
  (k+1) W/(D 2^l)): each tile runs all its fine Haar levels in one
  `sbt.haar_fwd_pyramid` call on its own columns (on CUDA tensors one
  call of kernel #5, csrc/sbt.cu) and its bands go to their global
  quadrant positions. The intra level-1 B4T (4 taps) reads a 2-column
  halo on each side from the neighbour tiles; the inverse's smoothing
  filter reads +-1 LL column, and `lh_col` at the right edge
  (ops/sbt.py).
- From `_replicate_level` on, the coarse tail runs once, on the region
  gathered on the first tile's device, and its result goes to every
  tile. Where a tile's share of a level's region would not be whole
  column pairs (W not a multiple of D 2^l), that level and those after
  it join the tail: the same values, computed there.

Neighbour columns and gathered regions move with `.to(device)` (a no-op
where the tiles share a device). The B4T, the inverse and the HZCC
quantization are PyTorch code, as in the JAX package (no kernel there
either); `encode_plane_tiled` quantizes the gathered plane on the first
tile's device. `tile_hook` serves the gop x tile encode
(parallel/gop.py): the encode core's transforms through these functions.
"""

import torch
import torch.nn.functional as F

from ..constants import round_shift
from ..ops import hzcc, sbt
from .mesh import Mesh


def _replicate_level(W: int, H: int, levels: int, D: int) -> int:
    """First level computed on the gathered region instead of per tile
    (the JAX package's rule, dsv1_tpu/parallel/tile.py:54-66): where the
    region width stops dividing evenly or drops below 16 columns per
    device."""
    for lvl in range(1, levels + 1):
        ws = round_shift(W, lvl - 1)
        if ws & 1 or ws < 16 * D:
            return lvl
    return levels + 1


def _tiled_levels(W: int, H: int, D: int) -> int:
    """The levels 1..m run per tile: those before `_replicate_level`
    whose region splits into whole column pairs per tile."""
    m = _replicate_level(W, H, sbt.nlevels(W, H), D) - 1
    w = W // D
    while m and w % (1 << m):
        m -= 1
    return m


def _devices(mesh: Mesh, axis: str) -> list:
    if mesh.axis_names != (axis,):
        raise ValueError(f"a 1-D mesh over '{axis}' is needed, not "
                         f"{mesh.axis_names}")
    return list(mesh.devices.reshape(-1))


def _split(a, devs) -> list:
    W = a.shape[-1]
    if W % len(devs):
        raise ValueError(f"width {W} does not split into {len(devs)} "
                         "column tiles")
    w = W // len(devs)
    return [a[..., k * w:(k + 1) * w].to(d) for k, d in enumerate(devs)]


def split_tiles(a, mesh: Mesh, axis: str = "tile") -> list:
    """a (..., H, W) as D column tiles, tile k on the mesh's device k;
    raises where D does not divide W (as the JAX package's device_put
    does)."""
    return _split(a, _devices(mesh, axis))


def join_tiles(tiles, device=None):
    """The array of column tiles, on `device` (the first tile's by
    default)."""
    dev = tiles[0].device if device is None else device
    return torch.cat([t.to(dev) for t in tiles], -1)


def _cols(tiles, c0: int, c1: int, r0: int, r1: int, dev):
    """Rows r0:r1, global columns c0:c1 of the column tiles, on dev."""
    w = tiles[0].shape[-1]
    parts = []
    for k, t in enumerate(tiles):
        lo, hi = max(c0, k * w), min(c1, (k + 1) * w)
        if lo < hi:
            parts.append(t[..., r0:r1, lo - k * w:hi - k * w].to(dev))
    return torch.cat(parts, -1)


def _place(pieces, lead, H: int, w: int, devs) -> list:
    """Column tiles of the (H, D w) array covered by the pieces (row,
    global column, tensor)."""
    out = [torch.zeros(lead + (H, w), dtype=torch.int32, device=d)
           for d in devs]
    for r0, c0, t in pieces:
        h, n = t.shape[-2:]
        for k, o in enumerate(out):
            lo, hi = max(c0, k * w), min(c0 + n, (k + 1) * w)
            if lo < hi:
                o[..., r0:r0 + h, lo - k * w:hi - k * w] = \
                    t[..., lo - c0:hi - c0].to(o.device)
    return out


def _check(tiles, devs):
    if len(tiles) != len(devs):
        raise ValueError(f"{len(tiles)} tiles for {len(devs)} devices")
    for t, d in zip(tiles, devs):
        if t.shape != tiles[0].shape:
            raise ValueError("column tiles must have the same shape")
        if t.device != d:
            raise ValueError(f"tile on {t.device}, its device is {d}")
    return tiles[0].shape[:-2], tiles[0].shape[-2], tiles[0].shape[-1]


def _fwd(tiles, is_p: bool, devs) -> list:
    """dsv_fwd_sbt over column tiles (see the module docstring)."""
    lead, H, w = _check(tiles, devs)
    D = len(devs)
    W = w * D
    lvls = sbt.nlevels(W, H)
    m = _tiled_levels(W, H, D)
    if m == 0:
        full = sbt.fwd_sbt(join_tiles(tiles), is_p)
        return _place([(0, 0, full)], lead, H, w, devs)
    pieces, lls = [], []
    for k, dev in enumerate(devs):
        first = 1
        region = tiles[k].to(torch.int32)
        if not is_p:
            # level 1: the B4T across the tile, with a 2-column halo on
            # each side (one pair of the horizontal pass's taps)
            e0, e1 = max(k * w - 2, 0), min((k + 1) * w + 2, W)
            ext = _cols(tiles, e0, e1, 0, H, dev).to(torch.int32)
            hb = sbt._b4t_fwd_rows(ext.mT).mT
            half, p0, n = (e1 - e0) // 2, (k * w - e0) // 2, w // 2
            v = sbt._b4t_fwd_rows(torch.cat(
                [hb[..., p0:p0 + n], hb[..., half + p0:half + p0 + n]], -1))
            ch = H // 2
            pieces += [(0, W // 2 + k * n, v[..., :ch, n:]),
                       (ch, k * n, v[..., ch:, :n]),
                       (ch, W // 2 + k * n, v[..., ch:, n:])]
            region = v[..., :ch, :n].contiguous()
            first = 2
        lout = torch.empty_like(region)
        sbt.haar_fwd_pyramid(region, lout, first, m)
        for i in range(first, m + 1):
            _ws, _hs, cw, ch, _fw, fh = sbt._quad_dims(W, H, i)
            n = cw // D
            pieces += [(0, cw + k * n, lout[..., :ch, n:2 * n]),
                       (ch, k * n, lout[..., ch:ch + fh, :n]),
                       (ch, cw + k * n, lout[..., ch:ch + fh, n:2 * n])]
        _ws, _hs, cw, ch, _fw, _fh = sbt._quad_dims(W, H, m)
        lls.append(lout[..., :ch, :cw // D])
    if m < lvls:
        # the coarse tail, once, on the gathered LL region
        region = torch.cat([t.to(devs[0]) for t in lls], -1).contiguous()
        tout = torch.empty_like(region)
        sbt.haar_fwd_pyramid(region, tout, m + 1, lvls)
        pieces.append((0, 0, tout))
    else:
        n = lls[0].shape[-1]
        pieces += [(0, k * n, t) for k, t in enumerate(lls)]
    return _place(pieces, lead, H, w, devs)


def _inv(tiles, q, is_p: bool, is_luma: bool, devs) -> list:
    """dsv_inv_sbt over column tiles (see the module docstring)."""
    lead, H, w = _check(tiles, devs)
    D = len(devs)
    W = w * D
    lvls = sbt.nlevels(W, H)
    m = _tiled_levels(W, H, D)
    tiles = [t.to(torch.int32) for t in tiles]
    if m == 0:
        return _split(sbt.inv_sbt(join_tiles(tiles), q, is_p, is_luma),
                      devs)
    # the coarse tail, once, on the gathered top-left region
    hs, ws = round_shift(H, m), round_shift(W, m)
    q0 = q.to(devs[0]) if isinstance(q, torch.Tensor) else q
    if m < lvls:
        a = _cols(tiles, 0, ws, 0, hs, devs[0])
        _, _, cwl, chl, _, _ = sbt._quad_dims(W, H, lvls)
        cur = sbt.inv_levels(a, a[..., :chl, :cwl], W, H, q0, is_p,
                             is_luma, lvls, m + 1)
    else:
        cur = _cols(tiles, 0, ws, 0, hs, devs[0])
    n = ws // D
    curs = [cur[..., k * n:(k + 1) * n].to(d) for k, d in enumerate(devs)]
    for i in range(m, 0, -1):
        ws, hs, cw, ch, fw, fh = sbt._quad_dims(W, H, i)
        n = cw // D
        nxt = []
        for k, dev in enumerate(devs):
            qk = q.to(dev) if isinstance(q, torch.Tensor) else q
            if isinstance(qk, torch.Tensor):
                qk = qk.to(torch.int32).reshape(qk.shape + (1, 1))
            c0, c1 = k * n, (k + 1) * n
            e0, e1 = max(c0 - 1, 0), min(c1 + 1, cw)
            cur = torch.cat(([curs[k - 1][..., -1:].to(dev)] if e0 < c0
                             else []) + [curs[k]]
                            + ([curs[k + 1][..., :1].to(dev)] if e1 > c1
                               else []), -1)
            LHr = _cols(tiles, cw + e0, cw + e1, 0, ch, dev)
            if i > 1 or is_p:
                hqp = sbt._hqp_for_level(qk, is_p, i) if is_luma else 0
                out = sbt._haar_inv_region(
                    cur, _cols(tiles, cw, cw + 1, 0, ch, dev),
                    _cols(tiles, e0, e1, ch, ch + 1, dev), LHr,
                    F.pad(_cols(tiles, e0, e1, ch, ch + fh, dev),
                          (0, 0, 0, ch - fh)),
                    F.pad(_cols(tiles, cw + e0, cw + e1, ch, ch + fh, dev),
                          (0, 0, 0, ch - fh)),
                    2 * (e1 - e0), hs, scale=i > 1, filtered=is_luma,
                    hqp=hqp, col0=e0, fw=fw)
            else:
                # level 1 of an intra plane: the B4T inverse, its
                # horizontal pass on a one-pair halo
                x = sbt._b4t_inv_rows(torch.cat([
                    torch.cat([cur, _cols(tiles, e0, e1, ch, hs, dev)], -2),
                    torch.cat([LHr, _cols(tiles, cw + e0, cw + e1, ch, hs,
                                          dev)], -2)], -1))
                out = sbt._b4t_inv_rows(x.mT).mT
            nxt.append(out[..., 2 * (c0 - e0):2 * (c1 - e0)])
        curs = nxt
    return [c.contiguous() for c in curs]


def fwd_sbt_tiled(tiles, is_p: bool, mesh: Mesh, axis: str = "tile"):
    """dsv_fwd_sbt over a frame's column tiles (`split_tiles`): the
    coefficient array's column tiles, equal to `sbt.fwd_sbt` of the
    joined frame."""
    return _fwd(tiles, bool(is_p), _devices(mesh, axis))


def inv_sbt_tiled(tiles, q, is_p: bool, is_luma: bool, mesh: Mesh,
                  axis: str = "tile"):
    """dsv_inv_sbt over a coefficient array's column tiles: the plane's
    column tiles, equal to `sbt.inv_sbt` of the joined array."""
    return _inv(tiles, q, bool(is_p), is_luma, _devices(mesh, axis))


def encode_plane_tiled(tiles, q: int, is_p: bool, plane_idx: int,
                       stable_blocks, nbh: int, nbv: int, mesh: Mesh,
                       axis: str = "tile"):
    """The per-plane encode core over column tiles (encode_picture's
    plane loop, dsv_encoder.c:505-526): forward SBT, adaptive
    quantization with in-loop write-back, (filtered) inverse SBT.
    Returns (the traversal-ordered quantized values and the raw DC, on
    the first tile's device, and the recon coefficients as column
    tiles), as the JAX package returns them (replicated, replicated,
    column-sharded)."""
    devs = _devices(mesh, axis)
    a = _fwd(tiles, bool(is_p), devs)
    full = join_tiles(a)
    H, W = full.shape[-2:]
    qv, wb = hzcc.encode_plane_core(
        full, q, bool(is_p), plane_idx,
        torch.as_tensor(stable_blocks).to(devs[0]),
        hzcc.build_tables(W, H, nbh, nbv))
    rec = _inv(split_tiles(wb, mesh, axis), q, bool(is_p), plane_idx == 0,
               devs)
    return qv, full[..., 0, 0], rec


class _TileHook:
    """The encode core's transforms over a gop x tile mesh row's devices:
    a batch of planes (..., H, W) on the row's first device is split
    into column tiles, transformed, and joined there again."""

    def __init__(self, devices):
        self.devs = list(devices)

    def fwd(self, coefs, is_p: bool):
        return join_tiles(_fwd(_split(coefs.to(torch.int32), self.devs),
                               is_p, self.devs), coefs.device)

    def inv(self, coefs, q, is_p: bool, is_luma: bool):
        return join_tiles(_inv(_split(coefs, self.devs), q, is_p, is_luma,
                               self.devs), coefs.device)


def tile_hook(devices) -> _TileHook:
    """The encode core's hook (models/encoder.py make_encode_core_traced
    `tile_hook`) for a row of tile devices (the JAX package's
    _make_tile_hook, dsv1_tpu/parallel/gop.py:198-223)."""
    return _TileHook(devices)
