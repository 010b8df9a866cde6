"""HZCC quantization with write-back of a frame's planes: the int32
coefficients read once, the written-back int32 array and the int32
traversal values (one a position of the subband traversal) written once."""


def nbytes(geo: dict, is_p: bool) -> int:
    return sum(8 * cw * ch + 4 * n for (cw, ch), n in zip(geo["dims"],
                                                            geo["n"]))
