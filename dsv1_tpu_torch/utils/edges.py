"""Level-0 motion-search inputs at the edges of their valid range, made
from a numpy seed: candidate fields at the +-E validity limits for
`hme_kernels.refine_level(level=0)` and a 9-point result `pre` at the
four edges of its search for `hme_kernels.refine_wide`. The kernels'
checks against their plain versions (`chip_smoke.py`) and the CPU tests
against the JAX package both feed these, so the edges they cover are
the same.
"""

import numpy as np
import torch


def edge_cands(rng, dev, B, nbh, nbv, w, h, BW, BH, E):
    """(B, nb, 6) cmx, cmy for level 0: slot 0 the zero MV, the rest
    mostly at the +-E validity limits of their block (one past them,
    on them or one inside), else small."""
    nb = nbh * nbv
    t = np.arange(nb)
    bx, by = (t % nbh) * BW, (t // nbh) * BH
    lims = (np.stack([-E - bx, w + E - np.minimum(w - bx, BW) - bx]),
            np.stack([-E - by, h + E - np.minimum(h - by, BH) - by]))
    cm = [rng.integers(-9, 10, (B, nb, 6)) for _ in range(2)]
    for c, lim in zip(cm, lims):
        for k in range(1, 6):
            at = lim[rng.integers(0, 2, (B, nb)), t] \
                + rng.integers(-1, 2, (B, nb))
            c[..., k] = np.where(rng.random((B, nb)) < 0.7, at, c[..., k])
        c[..., 0] = 0
    return tuple(torch.from_numpy(c.astype(np.int32)).to(dev) for c in cm)


def edge_pre(rng, dev, B, nbh, nbv, w, h, BW, BH):
    """(dx, dy, best), each (B, nb) int32: the 9-point search's extremes
    (the full-pel clamp -bw_c - bx .. w - bx, then +-1) mixed with small
    MVs per block, and every block of pair 0 at its top-left extreme
    (with 64-high blocks at effort >= 2, rows before the image's start);
    best up to 64 a pixel."""
    t = np.arange(nbh * nbv)
    bx, by = (t % nbh) * BW, (t // nbh) * BH
    bw_c, bh_c = np.clip(w - bx, 0, BW), np.clip(h - by, 0, BH)
    xs = np.stack([-bw_c - bx - 1, w - bx + 1, -bx, np.zeros_like(bx)])
    ys = np.stack([-bh_c - by - 1, h - by + 1, -by, np.zeros_like(by)])
    kx, ky = rng.integers(0, 4, (2, B, t.size))
    dx = xs[kx, t] + rng.integers(-2, 3, (B, t.size)) * (kx >= 2)
    dy = ys[ky, t] + rng.integers(-2, 3, (B, t.size)) * (ky >= 2)
    dx[0], dy[0] = xs[0], ys[0]
    best = rng.integers(0, BW * BH * 64, (B, t.size))
    return tuple(torch.from_numpy(a.astype(np.int32)).to(dev)
                 for a in (dx, dy, best))
