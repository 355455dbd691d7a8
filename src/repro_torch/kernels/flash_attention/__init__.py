"""The LM's flash-attention kernel (port of
`repro.kernels.flash_attention`).

`ops.flash_attention` is the CUDA kernel in ``csrc/flash_attention.cu`` on
a CUDA device and its plain PyTorch version `ref.attention_ref` on the
CPU.
"""
from . import ops, ref
from .ops import flash_attention
from .ref import attention_ref

__all__ = ["attention_ref", "flash_attention", "ops", "ref"]
