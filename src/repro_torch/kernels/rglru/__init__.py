"""The RG-LRU recurrence kernel (port of `repro.kernels.rglru`).

`ops.rglru_scan` is the CUDA kernel in ``csrc/rglru.cu`` on a CUDA device
and its plain PyTorch version `ref.rglru_scan_ref` on the CPU.
"""
from . import ops, ref
from .ops import rglru_scan
from .ref import rglru_scan_ref

__all__ = ["ops", "ref", "rglru_scan", "rglru_scan_ref"]
