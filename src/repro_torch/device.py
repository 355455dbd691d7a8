"""The port's device rule, shared by the simulator and the LM stack."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device a port entry point runs on: `device` when given, else
    CUDA.  Raises when CUDA is absent and the caller did not ask for the
    CPU — the port never falls back to the CPU silently."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path "
            "on the CPU")
    return torch.device("cuda")
