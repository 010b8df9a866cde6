"""The encode core's prologue of a frame: the u8 planes (and for a P
frame the u8 prediction) read once, the int32 centred coefficient
arrays written once."""


def nbytes(geo: dict, is_p: bool) -> int:
    px = sum(w * h for w, h, _ext in geo["planes"])
    n = sum(cw * ch for cw, ch in geo["dims"])
    return px * (2 if is_p else 1) + 4 * n
