"""The Mamba-2 SSD chunked-scan kernels (port of `repro.kernels.ssd_scan`).

`ops.ssd_scan` launches a CUDA kernel on a CUDA device (bf16 on the tensor
cores, ``csrc/ssd_scan_wgmma.cu``; fp32 on the FMA units,
``csrc/ssd_scan.cu``; `ops.kernel_for` says which) and runs its plain
PyTorch version `ref.ssd_ref` on the CPU.  `ref.ssd_chunk_ref` is the
tensor-core kernel's own decomposition, for the tests.
"""
from . import ops, ref
from .ops import ssd_scan
from .ref import ssd_chunk_ref, ssd_ref

__all__ = ["ops", "ref", "ssd_chunk_ref", "ssd_ref", "ssd_scan"]
