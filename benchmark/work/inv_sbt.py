"""The inverse subband pyramid with the recon epilogue of a frame's
planes: the int32 coefficients (and for a P frame the u8 prediction)
read once, the u8 plane with its replicated border written once."""


def nbytes(geo: dict, is_p: bool) -> int:
    total = 0
    for (w, h, ext), (cw, ch) in zip(geo["planes"], geo["dims"]):
        total += 4 * cw * ch + (w * h if is_p else 0) \
            + (w + 2 * ext) * (h + 2 * ext)
    return total
