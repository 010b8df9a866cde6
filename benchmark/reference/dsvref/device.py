"""Device selection: the card unless the caller asks for the CPU.

Every public entry point of the reference takes a `device`, "cuda" by
default; its plain PyTorch runs on whichever device it is given. Asking
for CUDA where there is none raises: there is no quiet CPU fallback.
"""

import torch


def resolve(device="cuda") -> torch.device:
    """torch.device for `device` ("cuda", "cuda:0", "cpu" or a
    torch.device); raises if CUDA is asked for and not available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           "available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
