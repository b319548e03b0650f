"""Device resolution for every entry point of the port.

The port is written for an NVIDIA GPU: ``device=None`` means ``cuda``,
and a machine without a GPU is an error, not a silent move to the CPU.
The CPU is used only when the caller asks for it by name (the parity
tests do), and there every kernel wrapper takes its plain PyTorch
version because the tensors it is handed lie on the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises ``RuntimeError`` without a GPU);
    anything else is passed to ``torch.device`` as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on a CUDA GPU and none is available; "
                "pass device='cpu' explicitly to run the plain PyTorch "
                "versions of its kernels on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev
