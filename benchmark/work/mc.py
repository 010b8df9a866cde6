"""Motion-compensated prediction of a P frame (all three planes): the
least bytes it needs, each predicted pixel read once from the reference
at its full-pel position and written once, and 16 bytes of mode, motion
vector and submask a block (half-pel neighbourhoods are left out, so the
count never exceeds what any kernel must move). I frames: none."""


def nbytes(geo: dict, is_p: bool) -> int:
    if not is_p:
        return 0
    px = sum(w * h for w, h, _ext in geo["planes"])
    return 2 * px + 16 * geo["blocks"]
