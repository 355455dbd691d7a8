"""The network simulator's grant kernel (port of `repro.kernels.netsim`).

`ops.grant` is the oracle step's age-based arbitration: the CUDA kernel
in ``csrc/grant.cu`` on a CUDA device, `ref.grant_ref` (plain PyTorch)
on the CPU.  The reference's second netsim kernel, `cycle_core` (the
fused and compact steps), is not ported yet.
"""
from .ops import grant
from .ref import grant_ref

__all__ = ["grant", "grant_ref"]
