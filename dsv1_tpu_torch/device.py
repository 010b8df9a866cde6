"""Device selection: explicit, never automatic.

Every public entry point of the port takes a `device`. On "cuda" the
hand-written kernels run; on "cpu" each kernel wrapper takes its plain
PyTorch version (used by the tests, which run without a GPU). Asking
for CUDA where there is none raises: there is no quiet CPU fallback.
"""

import torch


def resolve(device) -> torch.device:
    """torch.device for `device` ("cuda", "cuda:0", "cpu" or a
    torch.device); raises if CUDA is asked for and not available."""
    if device is None:
        raise ValueError("pass device='cuda' or device='cpu' explicitly")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           "available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev

