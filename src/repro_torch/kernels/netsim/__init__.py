"""The network simulator's kernels (port of `repro.kernels.netsim`).

`ops.grant` is the oracle step's age-based arbitration and
`ops.cycle_core` the fused and compact steps' arbitration core: the CUDA
kernels in ``csrc/grant.cu`` and ``csrc/cycle_core.cu`` on a CUDA
device, their plain PyTorch versions (`ref.grant_ref`,
`ref.cycle_core_ref`) on the CPU.
"""
from .ops import cycle_core, grant
from .ref import cycle_core_ref, grant_ref

__all__ = ["cycle_core", "cycle_core_ref", "grant", "grant_ref"]
