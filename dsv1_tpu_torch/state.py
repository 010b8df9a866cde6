"""Encoder state that crosses frames: the port's counterpart of the JAX
GOP scan's carry (DSV_ENCODER, dsv_encoder.h:83-110).

The codec has no weights and draws no random numbers; what a P-frame
step needs from the past is this state. `state_from_numpy` turns the
JAX package's numpy state (or any numpy state) into device tensors, so a
step of the port can start where a step of the JAX package ended.
"""

from dataclasses import dataclass

import numpy as np
import torch

from .device import resolve


@dataclass
class EncoderState:
    stability: torch.Tensor   # (nblk, 2) int32 accumulators (int16 values)
    refresh_ctr: int          # P frames since the last accumulator reset
    prev_al: int              # previous frame's average luma (SCD)
    ref_recon: torch.Tensor   # (flat,) u8 reference recon image
    rc: torch.Tensor | None = None   # ABR rate state, int32[8] (ops/rc.py)


def state_from_numpy(stability, refresh_ctr, prev_al, ref_recon,
                     device="cuda") -> EncoderState:
    """Device state from numpy arrays / ints: stability (nblk, 2) ints,
    ref_recon the flat extended image (ops/frame.py layout)."""
    dev = resolve(device)
    stab = np.asarray(stability).astype(np.int32).reshape(-1, 2)
    img = np.asarray(ref_recon, np.uint8).reshape(-1)
    return EncoderState(stability=torch.from_numpy(stab.copy()).to(dev),
                        refresh_ctr=int(refresh_ctr), prev_al=int(prev_al),
                        ref_recon=torch.from_numpy(img.copy()).to(dev))
