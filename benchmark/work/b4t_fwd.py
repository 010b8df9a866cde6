"""The intra level-1 B4T of an I frame's planes: int32 in, int32 out
and the int32 LL corner (a quarter of the values) copied out. P
frames: none."""


def nbytes(geo: dict, is_p: bool) -> int:
    if is_p:
        return 0
    return sum(9 * cw * ch for cw, ch in geo["dims"])
