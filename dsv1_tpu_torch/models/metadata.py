"""Stream metadata (mirrors DSV_META, reference dsv.h:86-95; the port's
copy of dsv1_tpu/models/metadata.py)."""

from dataclasses import dataclass


@dataclass
class Metadata:
    width: int
    height: int
    subsamp: int
    fps_num: int = 30
    fps_den: int = 1
    aspect_num: int = 1
    aspect_den: int = 1
