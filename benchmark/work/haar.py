"""The forward Haar pyramid of a frame's planes: each int32 of the
transformed region read once and each band value written once. P
planes run it from level 1 on the whole coefficient array; I planes from
level 2, on the level-1 LL corner (a quarter of it) that the B4T leaves."""


def nbytes(geo: dict, is_p: bool) -> int:
    n = sum(cw * ch for cw, ch in geo["dims"])
    return 8 * n if is_p else 8 * (n // 4)
