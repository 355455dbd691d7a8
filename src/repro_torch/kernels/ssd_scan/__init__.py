"""The Mamba-2 SSD chunked-scan kernel (port of `repro.kernels.ssd_scan`).

`ops.ssd_scan` is the CUDA kernel in ``csrc/ssd_scan.cu`` on a CUDA device
and its plain PyTorch version `ref.ssd_ref` on the CPU.
"""
from . import ops, ref
from .ops import ssd_scan
from .ref import ssd_ref

__all__ = ["ops", "ref", "ssd_ref", "ssd_scan"]
