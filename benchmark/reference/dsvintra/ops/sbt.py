"""The forward subband transform of an intra plane (dsv_fwd_sbt,
sbt.c:630-651, for I frames), integer-exact, in plain PyTorch: the
biorthogonal 4-tap transform (B4T) on level 1 (sbt.c:90-265), then a
Haar level at a time on the carried LL region, with the LL's truncating
4/5 scaling (sbt.c:267-349), each level's LH, HL and HH written into
their rectangles of the coefficient array and the last LL into its
top-left corner.

The sign-symmetric rounding shifts (round2, round4 and round8 of sbt.c)
are names of this module, looked up at each call: the control of
benchmark/harness/check.py replaces them here. The forward B4T reads
round2 alone; round4 and round8 belong to the inverse, which this
package takes from dsvref.
"""

import torch

from dsvref.ops.cint import lb2, round2, round4, round8, trunc_div

__all__ = ["round2", "round4", "round8", "fwd_intra"]


def _b4t(a, dim: int):
    """One pass of the forward B4T along `dim` (of even length n): the n/2
    low-pass values, then the n/2 high-pass values. Output i reads the
    samples 2i-1, 2i, 2i+1 and 2i+2, with sample 1 standing in for -1 and
    sample n-1 for n."""
    a = a.movedim(dim, -1)
    n = a.shape[-1]
    if n % 2:
        raise ValueError("B4T (intra level 1) requires even dimensions")
    even, odd = a[..., 0::2], a[..., 1::2]
    before = torch.cat([odd[..., :1], odd[..., :-1]], dim=-1)
    after = torch.cat([even[..., 1:], odd[..., -1:]], dim=-1)
    lo = round2(3 * even + 3 * odd - before - after)
    hi = round2(before - 3 * even + 3 * odd - after)
    return torch.cat([lo, hi], dim=-1).movedim(-1, dim)


def _haar(r):
    """One Haar level of the region r (hs, ws), its odd edge replicated:
    (LL scaled by 4/5, LH, HL, HH), the LL (ceil(hs/2), ceil(ws/2)) and
    each band cut to the region's whole pairs."""
    hs, ws = r.shape[-2:]
    if ws % 2:
        r = torch.cat([r, r[..., -1:]], dim=-1)
    if hs % 2:
        r = torch.cat([r, r[..., -1:, :]], dim=-2)
    a, b = r[..., 0::2, 0::2], r[..., 0::2, 1::2]
    c, d = r[..., 1::2, 0::2], r[..., 1::2, 1::2]
    ll = trunc_div((a + b + c + d) * 4, 5)
    fh, fw = hs // 2, ws // 2
    return (ll, (a - b + c - d)[..., :, :fw], (a + b - c - d)[..., :fh, :],
            (a - b - c + d)[..., :fh, :fw])


def fwd_intra(coefs):
    """The forward transform of a centred int32 plane (H, W), H and W
    even: the assembled coefficient array (H, W)."""
    H, W = coefs.shape[-2:]
    out = coefs.to(torch.int32)
    levels = lb2(max(W, H))
    if levels < 1:
        return out.clone()
    out = _b4t(_b4t(out, -1), -2)
    cur = out[..., :H // 2, :W // 2].clone()
    for _level in range(2, levels + 1):
        hs, ws = cur.shape[-2:]
        ch, cw = (hs + 1) // 2, (ws + 1) // 2
        cur, lh, hl, hh = _haar(cur)
        out[..., :ch, cw:cw + lh.shape[-1]] = lh
        out[..., ch:ch + hl.shape[-2], :cw] = hl
        out[..., ch:ch + hh.shape[-2], cw:cw + hh.shape[-1]] = hh
    out[..., :cur.shape[-2], :cur.shape[-1]] = cur
    return out
