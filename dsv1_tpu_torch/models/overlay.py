"""Decoder debug overlay: stability / motion vectors / intra sub-blocks
(the port's copy of dsv1_tpu/models/overlay.py).

Mirrors draw_info (reference dsv_decoder.c:147-243): block grid lines,
dashed markers for stable blocks, Bresenham motion vectors, and intra
sub-block dots, drawn onto the luma plane of a decoded frame copy.
Host-side numpy: diagnostics, not a hot path.
"""

import numpy as np

from ..constants import (MASK_INTRA00, MASK_INTRA01, MASK_INTRA10,
                         MASK_INTRA11, MODE_INTER, MODE_INTRA)

DRAW_STABHQ = 1
DRAW_MOVECS = 2
DRAW_IBLOCK = 4


def _drawvec(lp, x0, y0, x1, y1, bw, bh):
    """Bresenham MV line (dsv_decoder.c:147-182)."""
    h, w = lp.shape
    x0 = x0 + bw // 2
    y0 = y0 + bh // 2
    x1 += x0
    y1 += y0
    dx, dy = abs(x1 - x0), abs(y1 - y0)
    sx = 1 if x0 < x1 else -1
    sy = 1 if y0 < y1 else -1
    err = dx - dy
    if 0 <= y0 < h and 0 <= x0 < w:
        lp[y0, x0] = 0
    while x0 != x1 or y0 != y1:
        if 0 <= y0 < h and 0 <= x0 < w:
            lp[y0, x0] = 0
        e2 = 2 * err
        if e2 > -dy:
            err -= dy
            x0 += sx
        if e2 < dx:
            err += dx
            y0 += sy


def draw_info(planes, stable_blocks, modes, mvx, mvy, submask,
              blk_w, blk_h, nbh, nbv, mode_flags):
    """Render the overlay onto a copy of the planes; returns new planes."""
    lp = planes[0].copy()
    h, w = lp.shape
    for j in range(nbv):
        y = j * blk_h
        if y < h:
            lp[y, :] = 0
        for i in range(nbh):
            idx = i + j * nbh
            x = i * blk_w
            if x < w:
                lp[y:min(y + blk_h, h), x] = 0
            if (mode_flags & DRAW_STABHQ) and (stable_blocks[idx] & 1):
                a, b = x + blk_w // 2, y + blk_h // 2
                for k in range(-blk_w // 4, blk_w // 4 + 1):
                    if 0 <= b < h and 0 <= a + k < w:
                        lp[b, a + k] = (k & 1) * 255
            if modes is None:
                continue
            if (mode_flags & DRAW_MOVECS) and modes[idx] == MODE_INTER:
                _drawvec(lp, x, y, int(mvx[idx]), int(mvy[idx]), blk_w, blk_h)
            if (mode_flags & DRAW_IBLOCK) and modes[idx] == MODE_INTRA:
                for mask, fx, fy in ((MASK_INTRA00, 1, 1), (MASK_INTRA01, 3, 1),
                                     (MASK_INTRA10, 1, 3), (MASK_INTRA11, 3, 3)):
                    if submask[idx] & mask:
                        a = x + blk_w * fx // 4
                        b = y + blk_h * fy // 4
                        if 0 <= b < h and 0 <= a < w:
                            lp[b, a] = 255
    return [lp] + list(planes[1:])
