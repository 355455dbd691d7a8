"""The RG-LRU recurrence kernels (port of `repro.kernels.rglru`).

`ops.rglru_scan` is a CUDA kernel on a CUDA device (``csrc/rglru_ring.cu``
by the rule, ``csrc/rglru.cu`` when a call names it) and its plain
PyTorch version `ref.rglru_scan_ref` on the CPU.
"""
from . import ops, ref
from .ops import rglru_scan
from .ref import rglru_scan_ref

__all__ = ["ops", "ref", "rglru_scan", "rglru_scan_ref"]
