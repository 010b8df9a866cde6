"""Encoder state that crosses frames: the counterpart of the JAX GOP
scan's carry (DSV_ENCODER, dsv_encoder.h:83-110). The codec has no
weights and draws no random numbers; what a P-frame step needs from the
past is this state."""

from dataclasses import dataclass

import torch


@dataclass
class EncoderState:
    stability: torch.Tensor   # (nblk, 2) int32 accumulators (int16 values)
    refresh_ctr: int          # P frames since the last accumulator reset
    prev_al: int              # previous frame's average luma (SCD)
    ref_recon: torch.Tensor   # (flat,) u8 reference recon image
    rc: torch.Tensor | None = None   # ABR rate state, int32[8] (ops/rc.py)
