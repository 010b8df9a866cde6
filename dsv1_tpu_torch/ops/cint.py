"""C integer semantics as PyTorch ops (mirror of dsv1_tpu/ops/cint.py).

C `/` truncates toward zero: `torch.div(..., rounding_mode="trunc")`,
never `//` (which floors). Unsigned 32-bit wraparound is computed in
int64 and masked with `& U32`.
"""

import torch

U32 = 0xFFFFFFFF


def trunc_div(a, b):
    """C `/` on integer tensors (b a tensor or a python int)."""
    return torch.div(a, b, rounding_mode="trunc")


def tdiv(a: int, b: int) -> int:
    """C `/` on python ints."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def sym_round_shift(v, add: int, shift: int):
    """Sign-symmetric rounding shift: -((-v + add) >> shift) for v < 0
    (round2/round4/round8, reference sbt.c:62-88)."""
    r = (v.abs() + add) >> shift
    return torch.where(v < 0, -r, r)


def round2(v):
    return sym_round_shift(v, 1, 1)


def round4(v):
    return sym_round_shift(v, 2, 2)


def round8(v):
    return sym_round_shift(v, 4, 3)


def lb2(n):
    """dsv_lb2: smallest k such that (1 << k) >= n (hzcc.c:437-447), of a
    python int or, elementwise, of an integer tensor (n < 2^31): the
    count of powers of two below n."""
    if isinstance(n, torch.Tensor):
        return sum((n > (1 << j)).to(n.dtype) for j in range(31))
    k, i = 0, 1
    while i < n:
        i <<= 1
        k += 1
    return k


def cdiv(a, b: int):
    """C `/` of a python int, or elementwise of an integer tensor, by a
    python int."""
    if isinstance(a, torch.Tensor):
        return trunc_div(a, b)
    return tdiv(a, b)

