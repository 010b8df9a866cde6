"""Chroma downsampling converters for decoder output (reference
util.c:54-93; the port's copy of dsv1_tpu/utils/chroma.py)."""

import numpy as np


def conv444to422(src: np.ndarray) -> np.ndarray:
    h, w = src.shape
    s = src.astype(np.int32)
    idx = np.arange(0, w, 2)
    nxt = np.minimum(idx + 1, w - 1)
    return ((s[:, idx] + s[:, nxt] + 1) >> 1).astype(np.uint8)


def conv422to420(src: np.ndarray) -> np.ndarray:
    h, w = src.shape
    s = src.astype(np.int32)
    idx = np.arange(0, h, 2)
    nxt = np.minimum(idx + 1, h - 1)
    return ((s[idx, :] + s[nxt, :] + 1) >> 1).astype(np.uint8)
