"""Exact picture-packet byte lengths on the device (mirror of
dsv1_tpu/ops/piclen.py).

The ABR rate law (quality2quant, reference dsv_encoder.c:70-168) feeds
on the byte size of the previously packed picture (dsv_encoder.c:816-848).
Every component of the wire format has a closed-form bit length
(interleaved exp-Golomb: len(UEG(v)) = 2*floor(log2(v+1))+1, bs.c:128-157),
so a picture's packed size follows from the tensors the encode core
already holds (dense quantized traversal values, stability flags, motion
fields, DCs), without packing it. The packer (native/dsvbits.cpp) stays
the single source of the bytes; tests/test_torch_abr.py holds these
lengths against it. Wire layout:
  header        fourcc+ver+type 6B, prev/next links 8B, fnum 4B
  block dims    UEG(w/4) UEG(h/4), byte-aligned
  stability     UEG(len) aligned + ZBRLE bytes
  motion (P)    4 x [UEG(len) aligned + bytes]
  quant         qp_bits bits, alignment absorbed by the plane section
  plane x3      4B len + SEG(dc) aligned + 4B nruns aligned +
                run/value symbols aligned + 1B EOP
Sums run in int64; the result is the int32 the JAX package computes.
"""

import torch
import torch.nn.functional as F

from ..constants import MODE_INTER


def ueg_len(v):
    """Bit length of UEG(v) = 2*floor(log2(v+1)) + 1; v >= 0, elementwise."""
    _, e = torch.frexp((torch.as_tensor(v).to(torch.int64) + 1)
                       .to(torch.float64))
    return 2 * (e.to(torch.int64) - 1) + 1


def seg_len(v):
    """Bit length of SEG(v): UEG(|v|) plus a sign bit when v != 0."""
    a = torch.as_tensor(v).to(torch.int64).abs()
    return ueg_len(a) + (a != 0).to(torch.int64)


def neg_len(v):
    """Bit length of NEG(v): UEG(|v|-1) plus a sign bit; v != 0."""
    return ueg_len(torch.as_tensor(v).to(torch.int64).abs() - 1) + 1


def _ceil8(bits):
    return (bits + 7) >> 3


def _prev_one_excl(ones, idx):
    """Index of the previous set position strictly before each element
    (-1 if none), the JAX package's exclusive running max of idx over the
    mask. Built from a cumsum, a scatter and a gather: PyTorch's 1-D
    cummax runs as one serial scan on the GPU (7 ms per 4K plane)."""
    n = ones.shape[0]
    rank = torch.cumsum(ones.to(torch.int64), 0)   # set flags up to i
    # at[r] = index of the r-th set flag (at[0] = -1); unset positions
    # write to the spare last slot, which is never read
    at = idx.new_full((n + 2,), -1)
    at.scatter_(0, torch.where(ones, rank, n + 1), idx)
    return at[rank - ones.to(torch.int64)]


def zbrle_bytes(ones):
    """Byte length of the ZBRLE substream of a flag vector: one UEG per
    set flag coding the zero-run before it, plus the trailing run."""
    ones = ones.reshape(-1).to(torch.bool)
    n = ones.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=ones.device)
    prev = _prev_one_excl(ones, idx)
    bits = torch.where(ones, ueg_len(idx - prev - 1), 0).sum()
    last = torch.where(ones, idx, -1).max()
    return _ceil8(bits + ueg_len(n - 1 - last))


def _substream_bytes(payload_bytes):
    """A length-prefixed aligned substream: UEG(len) aligned + len bytes."""
    return _ceil8(ueg_len(payload_bytes)) + payload_bytes


def plane_section_bytes(qvals, dc):
    """Byte length of one coefficient plane section (hzcc.c:449-496):
    [u32 len][SEG dc][pad][u32 nruns][pad][UEG run / NEG value
    symbols][pad][0x55]."""
    qv = qvals.reshape(-1).to(torch.int64)
    nz = qv != 0
    idx = torch.arange(qv.shape[0], dtype=torch.int64, device=qv.device)
    prev = _prev_one_excl(nz, idx)
    sym = torch.where(nz, ueg_len(idx - prev - 1)
                      + neg_len(torch.where(nz, qv, 1)), 0)
    return 4 + _ceil8(seg_len(dc)) + 4 + _ceil8(sym.sum()) + 1


def _mv_pred(left, top, topleft):
    """dsv_movec_pred component predictor (dsv.c:189-231): of {left,
    top}, the one closer to left+top-topleft."""
    dif = left + top - topleft
    return torch.where((dif - left).abs() < (dif - top).abs(), left, top)


def motion_bytes(mode, mvx, mvy, submask, nbh: int, nbv: int):
    """Total byte length of the four motion substreams with their UEG
    length prefixes (encode_motion, dsv_encoder.c:256-327): mode ZBRLE,
    MV-x/y SEG residuals vs the raster predictor, intra sub-block masks
    (1 bit for full-intra, else 5)."""
    i64 = torch.int64
    inter = mode.reshape(nbv, nbh) == MODE_INTER
    ex = torch.where(inter, mvx.reshape(nbv, nbh).to(i64), 0)
    ey = torch.where(inter, mvy.reshape(nbv, nbh).to(i64), 0)

    def pred(a):
        left = F.pad(a, (1, 0))[:, :-1]
        top = F.pad(a, (0, 0, 1, 0))[:-1, :]
        topleft = F.pad(a, (1, 0, 1, 0))[:-1, :-1]
        return _mv_pred(left, top, topleft)

    bits_x = torch.where(inter, seg_len(ex - pred(ex)), 0).sum()
    bits_y = torch.where(inter, seg_len(ey - pred(ey)), 0).sum()
    sm = submask.reshape(nbv, nbh)
    bits_s = torch.where(inter, 0, torch.where(sm == 0xF, 1, 5)).sum()
    mode_b = zbrle_bytes(~inter)  # UEG per intra block + trailing run
    return (_substream_bytes(mode_b)
            + _substream_bytes(_ceil8(bits_x))
            + _substream_bytes(_ceil8(bits_y))
            + _substream_bytes(_ceil8(bits_s)))


def picture_len(blk_w: int, blk_h: int, nbh: int, nbv: int, qp_bits: int,
                stable, has_ref: bool, mode, mvx, mvy, submask, qvals, dcs):
    """Exact byte length (0-d int32 tensor) of the picture packet the
    native packer emits for these tensors. has_ref is known on the host:
    a picture without a reference carries no motion section, so
    mode/mvx/mvy/submask may then be None."""
    def ueg_len_py(v: int) -> int:  # the block dims are host ints
        return 2 * ((v + 1).bit_length() - 1) + 1

    head = 18 + ((ueg_len_py(blk_w >> 2) + ueg_len_py(blk_h >> 2) + 7) >> 3)
    total = head + _substream_bytes(zbrle_bytes((stable.reshape(-1) & 1)
                                                != 0))
    if has_ref:
        total = total + motion_bytes(mode, mvx, mvy, submask, nbh, nbv)
    total = total + _ceil8(qp_bits)  # quant field + pre-plane alignment
    for qv, dc in zip(qvals, dcs):
        total = total + plane_section_bytes(qv, dc)
    return total.to(torch.int32)
