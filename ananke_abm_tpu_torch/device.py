"""Device resolution and the float32 matmul policy of the port.

The reference computes float32 matmuls in full float32, so the port turns
TF32 off for both cuBLAS matmuls and cuDNN convolutions (PyTorch enables
TF32 for cuDNN by default, which keeps only ~3 decimal digits).
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device) -> torch.device:
    """``"cpu"``, ``"cuda"``, ``"cuda:1"`` or a ``torch.device`` -> a
    ``torch.device``. Raises ``RuntimeError`` when a CUDA device is
    requested and none is present (there is no silent CPU fallback)."""
    if device is None:
        raise ValueError("device is required: pass 'cpu' or 'cuda'")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is False"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {device!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) are present"
            )
    return dev
