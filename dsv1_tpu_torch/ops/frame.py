"""Frame memory model: C-layout flat images (mirror of dsv1_tpu/ops/frame.py).

A frame is one contiguous uint8 allocation: three planes, each with a
256-byte-aligned stride and a 64 px replicated border, plus zero guard
margins at both ends. Motion-compensation filter taps read a few bytes
past row and plane edges; keeping the same flat layout as the JAX
package makes those reads land on the same bytes.

Functions take tensors with any leading batch dimensions; the last
dimension is the flat image (or the plane's columns).
"""

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..constants import (FRAME_BORDER, format_h_shift, format_v_shift,
                         round_pow2, round_shift)


@dataclass(frozen=True, eq=False)
class PlaneGeom:
    offset: int   # flat index of pixel (0, 0)
    stride: int
    w: int
    h: int
    ext: int      # border size (0 or 64)


@dataclass(frozen=True, eq=False)
class FrameLayout:
    subsamp: int
    width: int
    height: int
    border: bool
    planes: tuple  # (PlaneGeom, PlaneGeom, PlaneGeom)
    total: int     # total flat size
    margin: int    # tail guard so filter taps never index past the array


@lru_cache(maxsize=64)
def make_layout(subsamp: int, width: int, height: int,
                border: bool) -> FrameLayout:
    """dsv_mk_frame geometry (frame.c:63-120) with the JAX package's
    256-byte stride alignment and 4-row guard margins."""
    ext = FRAME_BORDER if border else 0
    hs, vs = format_h_shift(subsamp), format_v_shift(subsamp)
    cw, ch = round_shift(width, hs), round_shift(height, vs)
    planes = []
    base = 0
    for (w, h) in ((width, height), (cw, ch), (cw, ch)):
        stride = round_pow2(w + ext * 2, 8)
        planes.append(PlaneGeom(offset=base + stride * ext + ext,
                                stride=stride, w=w, h=h, ext=ext))
        base += stride * (h + ext * 2)
    margin = max(p.stride for p in planes) * 4
    return FrameLayout(subsamp=subsamp, width=width, height=height,
                       border=border, planes=tuple(planes),
                       total=base, margin=margin)


def alloc_image(layout: FrameLayout, device="cuda"):
    """Zeroed flat image (calloc semantics) with guard margins."""
    return torch.zeros(layout.total + 2 * layout.margin, dtype=torch.uint8,
                       device=device)


def flat_base(layout: FrameLayout, c: int) -> int:
    """Flat index (into the margined array) of plane c's pixel (0, 0)."""
    return layout.margin + layout.planes[c].offset


def _ext_rows(img, layout: FrameLayout, c: int):
    """(..., h + 2 ext, stride) view of plane c's full row block."""
    p = layout.planes[c]
    start = layout.margin + p.offset - p.stride * p.ext - p.ext
    seg = img[..., start:start + p.stride * (p.h + 2 * p.ext)]
    return seg.reshape(img.shape[:-1] + (p.h + 2 * p.ext, p.stride))


def plane_view(img, layout: FrameLayout, c: int):
    """(..., h, w) view of a plane's core pixels."""
    p = layout.planes[c]
    return _ext_rows(img, layout, c)[..., p.ext:p.ext + p.h,
                                     p.ext:p.ext + p.w]


def plane_view_ext(img, layout: FrameLayout, c: int, pad: int):
    """(..., h + pad, w + pad) view including `pad` border pixels
    right of and below the core."""
    p = layout.planes[c]
    return _ext_rows(img, layout, c)[..., p.ext:p.ext + p.h + pad,
                                     p.ext:p.ext + p.w + pad]


def _ext_plane_rows(plane2d, p: PlaneGeom):
    """One plane's full row block: edge-replicated border plus zero
    stride tail, flattened over the last two dims."""
    x = plane2d.to(torch.uint8)
    h, w = x.shape[-2:]
    e = p.ext
    if e:
        dev = x.device
        ri = torch.arange(-e, h + e, device=dev).clamp_(0, h - 1)
        ci = torch.arange(-e, w + e, device=dev).clamp_(0, w - 1)
        x = x.index_select(-2, ri).index_select(-1, ci)
    tail = p.stride - x.shape[-1]
    if tail:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (tail,))], dim=-1)
    return x.reshape(x.shape[:-2] + (-1,))


def image_from_planes(layout: FrameLayout, planes):
    """Extended flat image(s) from three (..., h, w) planes: the plane
    row blocks are contiguous in the flat layout, so one concatenate."""
    y = planes[0]
    lead = y.shape[:-2]
    z = y.new_zeros(lead + (layout.margin,), dtype=torch.uint8)
    segs = [z]
    for c in range(3):
        segs.append(_ext_plane_rows(planes[c], layout.planes[c]))
    segs.append(z)
    return torch.cat(segs, dim=-1)


def image_from_luma(layout: FrameLayout, luma):
    """Extended image(s) with only the luma plane populated (pyramid
    levels: chroma stays zero like the reference's calloc'd frames)."""
    p0 = layout.planes[0]
    lead = luma.shape[:-2]
    rest = layout.total - p0.stride * (p0.h + 2 * p0.ext)
    return torch.cat([
        luma.new_zeros(lead + (layout.margin,), dtype=torch.uint8),
        _ext_plane_rows(luma, p0),
        luma.new_zeros(lead + (rest + layout.margin,), dtype=torch.uint8),
    ], dim=-1)


def ds2x_luma(plane2d, dw: int, dh: int):
    """2x2 box-filter luma downsample (dsv_ds2x_frame_luma,
    frame.c:240-261). plane2d is the extended luma view, large enough
    for 2*dh x 2*dw reads (odd source dims read one row/col into the
    border)."""
    a = plane2d[..., :2 * dh, :2 * dw].to(torch.int32)
    s = (a[..., 0::2, 0::2] + a[..., 0::2, 1::2]
         + a[..., 1::2, 0::2] + a[..., 1::2, 1::2])
    return ((s + 2) >> 2).to(torch.uint8)


def avg_luma(plane2d):
    """dsv_frame_avg_luma (frame.c:223-238): truncating mean over the
    last two dims (int64 sum; exact for any real plane)."""
    n = plane2d.shape[-1] * plane2d.shape[-2]
    s = plane2d.to(torch.int64).sum(dim=(-2, -1))
    return torch.div(s, n, rounding_mode="floor")


def flat_windows(flat, base, H: int, W: int, stride: int):
    """Gather (..., H, W) windows from a 1-D tensor: window k starts at
    flat index base[k] and its rows are `stride` apart."""
    dev = flat.device
    off = (torch.arange(H, device=dev)[:, None] * stride
           + torch.arange(W, device=dev)[None, :])
    idx = base.to(torch.int64)[..., None, None] + off
    return flat[idx]


def plane_sizes(subsamp: int, w: int, h: int):
    """(luma, chroma) element counts of one packed planar frame, plus
    the chroma dims."""
    cw = round_shift(w, format_h_shift(subsamp))
    ch = round_shift(h, format_v_shift(subsamp))
    return w * h, cw * ch, cw, ch


def split_packed_planes(packed, subsamp: int, w: int, h: int):
    """(..., fsz) packed planar uint8 -> (y, u, v) in raw planar YUV
    file order (dsv.c:98-170)."""
    ysz, csz, cw, ch = plane_sizes(subsamp, w, h)
    lead = packed.shape[:-1]
    return (packed[..., :ysz].reshape(lead + (h, w)),
            packed[..., ysz:ysz + csz].reshape(lead + (ch, cw)),
            packed[..., ysz + csz:ysz + 2 * csz].reshape(lead + (ch, cw)))


def np_pack_planes(planes) -> np.ndarray:
    """Host side: (y, u, v) -> one (fsz,) uint8 planar byte array (one
    host-to-device copy per frame)."""
    return np.concatenate([np.asarray(p, np.uint8).ravel()
                           for p in planes[:3]])
