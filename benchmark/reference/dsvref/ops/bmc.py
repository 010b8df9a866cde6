"""Block motion compensation (mirror of dsv1_tpu/ops/bmc.py).

`compensate_frame` builds the prediction of all three planes of a P
frame, or of a batch of P frames, at once (ops/mc.py; the half-pel
filters, luma 4-tap 9*(p0+p1)-(p-1+p2) and chroma bilinear, reference
bmc.c:57-174, run per block). The residual helpers are the reference's
addf/subf. `residual_in`, the encode core's prologue (subf, the
centring and the border column of every plane of a frame or a batch),
is the JAX package's dsv1_tpu/models/encoder.py:219-258 in plain
PyTorch; the recon's addf runs in the inverse transform's epilogue
(ops/sbt.py `inv_sbt_recon`).
"""


import torch

from . import frame as fr, mc
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


def residual_in_plain(img, layout: FrameLayout, coef_dims, preds=None):
    """The plain version of residual_in."""
    out = []
    for c in range(3):
        p = layout.planes[c]
        cw, ch = coef_dims[c]
        src_ext = fr.plane_view_ext(img, layout, c, cw - p.w)
        src_core = src_ext[..., :p.h, :p.w]
        core = src_core if preds is None else sub_residual(src_core,
                                                           preds[c])
        coefs = torch.zeros(img.shape[:-1] + (ch, cw), dtype=torch.int32,
                            device=img.device)
        coefs[..., :p.h, :p.w] = core.to(torch.int32) - 128
        if cw > p.w:
            # p2sbc reads the replicated border column (original edge)
            coefs[..., :p.h, p.w:cw] = \
                src_ext[..., :p.h, p.w:cw].to(torch.int32) - 128
        out.append(coefs)
    return out


def residual_in(img, layout: FrameLayout, coef_dims, preds=None):
    """The centred int32 coefficient planes (encode_picture's p2sbc,
    dsv_encoder.c:505-526) of a frame's flat image (n,) u8, or of a batch
    (C, n): per plane c of coefficient dims coef_dims[c] = (cw, ch), the
    (..., ch, cw) array holding clamp(src - pred + 128) - 128 (P frames:
    preds the three (..., h, w) u8 MC predictions) or src - 128 (I
    frames: preds None) on the plane, the image's replicated border
    column minus 128 where cw exceeds the plane's width, 0 on rows below
    it."""
    return residual_in_plain(img, layout, coef_dims, preds)

