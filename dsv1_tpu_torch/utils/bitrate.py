"""Heuristic bitrate estimator for ABR auto mode (reference util.c:21-52;
the port's copy of dsv1_tpu/utils/bitrate.py)."""

from ..constants import (GOP_INTRA, SUBSAMP_411, SUBSAMP_420, SUBSAMP_422,
                         SUBSAMP_444)
from ..models.metadata import Metadata


def estimate_bitrate(quality_pct: int, gop: int, meta: Metadata) -> int:
    fps = (meta.fps_num + meta.fps_den // 2) // meta.fps_den
    if meta.subsamp == SUBSAMP_444:
        bpf = 352 * 288 * 3
    elif meta.subsamp == SUBSAMP_422:
        bpf = 352 * 288 * 2
    else:  # 420 / 411
        bpf = 352 * 288 * 3 // 2
    if gop == GOP_INTRA:
        bpf *= 4
    if meta.width < 320 and meta.height < 240:
        bpf //= 4
    maxdimratio = (((meta.width + meta.height) // 2) << 8) // 352
    bpf = bpf * maxdimratio >> 8
    bps = bpf * fps
    return (bps // (26 - quality_pct // 4)) * 3 // 2
