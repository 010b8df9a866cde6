"""Block motion compensation (mirror of dsv1_tpu/ops/bmc.py).

`compensate_frame` builds the prediction of all three planes of a P
frame, or of a batch of P frames, at once (ops/mc.py: the MC kernel on
CUDA, one launch per call;
the half-pel filters, luma 4-tap 9*(p0+p1)-(p-1+p2) and chroma
bilinear, reference bmc.c:57-174, run per block inside it). The residual
helpers are the reference's addf/subf.
"""

import torch

from . import mc
from .frame import FrameLayout


def compensate_frame(ref_img, layout: FrameLayout, blk_w: int, blk_h: int,
                     nbh: int, nbv: int, modes, mvx, mvy, submask):
    """D.1/D.2 compensate (bmc.c:204-302) of every plane: the three
    (h, w) u8 predictions, views of one buffer, from the flat extended
    reference image and the frame's per-block fields; for a batch, images
    (C, n) and fields (C, ...), the three (C, h, w) predictions."""
    flat = mc.predict_frame(ref_img, layout, blk_w, blk_h, nbh, nbv, modes,
                            mvx, mvy, submask)
    planes, _ = mc.frame_geometry(layout, blk_w, blk_h)
    return tuple(flat[..., g.out_off:g.out_off + g.h * g.w]
                 .unflatten(-1, (g.h, g.w)) for g in planes)


def add_residual(pred, dif):
    """addf (bmc.c:29-41): clamp(pred + dif - 128)."""
    v = pred.to(torch.int32) + dif.to(torch.int32) - 128
    return v.clamp(0, 255).to(torch.uint8)


def sub_residual(inp, pred):
    """subf (bmc.c:43-55): residual = clamp(inp - pred + 128)."""
    v = inp.to(torch.int32) - pred.to(torch.int32) + 128
    return v.clamp(0, 255).to(torch.uint8)
