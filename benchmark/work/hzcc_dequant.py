"""HZCC dequantization of a frame's planes: the int32 grid of
quantized values read once and the int32 coefficients written once."""


def nbytes(geo: dict, is_p: bool) -> int:
    return sum(8 * cw * ch for cw, ch in geo["dims"])
