"""Block motion compensation (mirror of dsv1_tpu/ops/bmc.py).

`compensate_frame` builds the prediction of all three planes of a P
frame, or of a batch of P frames, at once (ops/mc.py: the MC kernel on
CUDA, one launch per call;
the half-pel filters, luma 4-tap 9*(p0+p1)-(p-1+p2) and chroma
bilinear, reference bmc.c:57-174, run per block inside it). The residual
helpers are the reference's addf/subf. `residual_in`, the encode core's
prologue (subf, the centring and the border column of every plane of a
frame or a batch), launches csrc/recon.cu on CUDA tensors (it replaces
the XLA code of dsv1_tpu/models/encoder.py:219-258) and runs its plain
version on CPU tensors; the recon's addf is fused into the inverse
transform's kernel (ops/sbt.py `inv_sbt_recon`).
"""

import ctypes

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
    it. CUDA tensors: one launch of csrc/recon.cu for the three planes of
    the batch (three contiguous blocks of one buffer); CPU tensors: the
    plain version."""
    if not img.is_cuda:
        return residual_in_plain(img, layout, coef_dims, preds)
    from ..kernels.build import LAUNCHES, launch
    if img.dtype != torch.uint8 or img.dim() not in (1, 2) \
            or img.stride(-1) != 1 \
            or img.shape[-1] != layout.total + 2 * layout.margin:
        raise ValueError("img must be the (n,) or (C, n) u8 images of the "
                         "layout")
    C = img.shape[0] if img.dim() == 2 else 1
    lead = img.shape[:-1]
    sizes = [C * ch * cw for (cw, ch) in coef_dims]
    buf = torch.empty(sum(sizes), dtype=torch.int32, device=img.device)
    pbase, pb = None, 0
    if preds is not None:
        pbase = min(t.data_ptr() for t in preds)
        for t, p in zip(preds, layout.planes):
            if t.dtype != torch.uint8 or t.device != img.device \
                    or t.shape != lead + (p.h, p.w) or t.stride(-1) != 1 \
                    or (C > 1 and t.stride(0) != preds[0].stride(0)):
                raise ValueError("preds must be the three (..., h, w) u8 "
                                 "predictions, one batch stride")
        pb = preds[0].stride(0) if C > 1 else 0
    geo, off = [], 0
    for c in range(3):
        p = layout.planes[c]
        cw, ch = coef_dims[c]
        if not (p.w <= cw <= p.w + p.ext and p.h <= ch):
            raise ValueError("coefficient dims must cover the plane")
        pr = (0, 0) if preds is None else (preds[c].data_ptr() - pbase,
                                           preds[c].stride(-2))
        geo += [fr.flat_base(layout, c), p.stride, *pr, off, p.h, p.w, ch,
                cw]
        off += sizes[c]
    launch("dsv1_residual_in", img, img.data_ptr(),
           img.stride(0) if C > 1 else 0, pbase, pb, buf.data_ptr(),
           (ctypes.c_int64 * 27)(*geo), C, int(preds is not None))
    LAUNCHES["residual_in"] += 1
    out, off = [], 0
    for c, (cw, ch) in enumerate(coef_dims):
        out.append(buf[off:off + sizes[c]].view(lead + (ch, cw)))
        off += sizes[c]
    return out
