"""Device choice shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the GPU. Without CUDA this raises instead of running on the
    CPU: a caller that wants the CPU (the tests) asks for it with ``"cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run the port on the CPU"
        )
    return dev
