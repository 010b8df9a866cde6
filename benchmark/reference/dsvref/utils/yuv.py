"""Raw planar YUV file input (reference dsv.c:98-170; a copy of
dsv1_tpu/utils/yuv.py's reader)."""

import numpy as np

from ..constants import format_h_shift, format_v_shift, round_shift


def frame_size(w: int, h: int, subsamp: int) -> int:
    hs, vs = format_h_shift(subsamp), format_v_shift(subsamp)
    cw, ch = round_shift(w, hs), round_shift(h, vs)
    return w * h + 2 * cw * ch


def read_frame(f, fno: int, w: int, h: int, subsamp: int):
    """Seek-read frame fno; returns (y, u, v) or None at EOF."""
    fsz = frame_size(w, h, subsamp)
    f.seek(fno * fsz)
    data = f.read(fsz)
    if len(data) < fsz:
        return None
    hs, vs = format_h_shift(subsamp), format_v_shift(subsamp)
    cw, ch = round_shift(w, hs), round_shift(h, vs)
    a = np.frombuffer(data, np.uint8)
    return (a[:w * h].reshape(h, w),
            a[w * h:w * h + cw * ch].reshape(ch, cw),
            a[w * h + cw * ch:].reshape(ch, cw))

