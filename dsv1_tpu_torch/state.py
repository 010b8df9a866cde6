"""Encoder state that crosses frames: the port's counterpart of the JAX
GOP scan's carry and of the JAX sequential encoder's state_dict
(DSV_ENCODER, dsv_encoder.h:83-110).

The codec has no weights and draws no random numbers; what a P-frame
step needs from the past is this state. `state_from_numpy` turns the
JAX package's numpy state (or any numpy state) into device tensors, so a
step of the port can start where a step of the JAX package ended;
`encoder_tensors` does the same for the device half of an
`Encoder.state_dict()` (the JAX package's or the port's).
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


def _stability(stability, dev):
    """(nblk, 2) int32 tensor from any integer array (the JAX encoder
    keeps int16)."""
    stab = np.asarray(stability).astype(np.int32).reshape(-1, 2)
    return torch.from_numpy(stab.copy()).to(dev)


def _image(img, dev):
    """Flat u8 image tensor (ops/frame.py layout) from an array."""
    return torch.from_numpy(np.asarray(img, np.uint8).reshape(-1).copy()) \
        .to(dev)


def state_from_numpy(stability, refresh_ctr, prev_al, ref_recon,
                     device="cuda") -> EncoderState:
    """Device state from numpy arrays / ints: stability (nblk, 2) ints,
    ref_recon the flat extended image (ops/frame.py layout)."""
    dev = resolve(device)
    return EncoderState(stability=_stability(stability, dev),
                        refresh_ctr=int(refresh_ctr), prev_al=int(prev_al),
                        ref_recon=_image(ref_recon, dev))


def encoder_tensors(s: dict, device="cuda"):
    """(stability, ref_recon, ref_pyr) device tensors from an
    `Encoder.state_dict()`: stability int16 (nblk, 2) into int32, the
    reference images as flat u8; None where the state has none."""
    dev = resolve(device)
    return (None if s["stability"] is None
            else _stability(s["stability"], dev),
            None if s["ref_recon"] is None else _image(s["ref_recon"], dev),
            None if s["ref_pyr"] is None
            else [_image(x, dev) for x in s["ref_pyr"]])
