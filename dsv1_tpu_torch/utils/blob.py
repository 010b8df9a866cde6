"""Many device tensors to the host in one copy.

`fetch` lays the tensors' bytes end to end in one uint8 tensor on the
device (the widest dtypes first, so every piece stays aligned on the
host), copies that once, into pinned memory from a CUDA device, and
hands back numpy views of the pieces. The encoders read each GOP's (or
frame's) compacted planes, DCs, stable blocks and motion fields this
way (the JAX package's blob_concat / blob_split, dsv1_tpu/ops/opt.py).
`to_host` reads one tensor. Both count each read in `STATS`
(`host_reads`, and its bytes in `d2h_bytes`), whatever the device.
"""

import numpy as np
import torch

from .stats import STATS

_NP = {torch.int32: np.int32, torch.int16: np.int16, torch.int8: np.int8,
       torch.uint8: np.uint8, torch.bool: np.bool_}


def fetch(parts: dict) -> dict:
    """{name: tensor} on one device -> {name: numpy array of the tensor's
    dtype and shape}, through one device-to-host copy."""
    items = sorted(parts.items(), key=lambda kv: -kv[1].element_size())
    flat = [t.reshape(-1).contiguous().view(torch.uint8) for _, t in items]
    buf = torch.cat(flat)
    if buf.is_cuda:
        host = torch.empty(buf.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(buf)
    else:
        host = buf
    raw = host.numpy()
    _count(raw.nbytes)
    out, off = {}, 0
    for (name, t), f in zip(items, flat):
        n = f.numel()
        out[name] = raw[off:off + n].view(_NP[t.dtype]).reshape(
            tuple(t.shape))
        off += n
    return out


def to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array, through one blocking copy from its
    device."""
    a = t.cpu().numpy()
    _count(a.nbytes)
    return a


def _count(nbytes: int):
    STATS["host_reads"] += 1
    STATS["d2h_bytes"] += nbytes


def fetch_dense(frames) -> np.ndarray:
    """Frames' quantized planes (per frame, a list of 1-D tensors) as one
    (n frames, values) int32 host array, through `fetch`: 4 bytes a value
    whatever dtype the planes were computed in."""
    return fetch({"dense": torch.stack([
        torch.cat([q.reshape(-1).to(torch.int32) for q in planes])
        for planes in frames])})["dense"]
