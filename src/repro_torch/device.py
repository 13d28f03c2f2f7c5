"""Device selection shared by every public entry point of the port.

``device=None`` means the CUDA device.  A machine without CUDA raises
rather than running on the CPU behind the caller's back; the CPU is used
only when the caller asks for it (``device="cpu"``, as the tests do).
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises ``RuntimeError`` without CUDA); any
    other value is taken as given (``"cpu"``, ``"cuda:1"``, a
    ``torch.device``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on the CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch path "
                "on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    return dev
