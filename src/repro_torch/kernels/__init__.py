"""Hand-written Hopper kernels of the port, one package per TPU kernel of
the reference (`repro.kernels`), each with a plain PyTorch version
(`ref`), an engine-facing wrapper (`ops`) and its CUDA sources
(`csrc/`), built by `build`."""
from __future__ import annotations

import torch


def refuse_autograd(name: str, *tensors) -> None:
    """Raise where autograd would record a kernel launch: the kernels are
    forward only (as the reference's, which have no `custom_vjp`) and
    their outputs carry no `grad_fn`, so a gradient through them would
    silently treat them as constants."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward; call it under "
            f"torch.no_grad() or torch.inference_mode(), or train with "
            f"another attn_impl")
