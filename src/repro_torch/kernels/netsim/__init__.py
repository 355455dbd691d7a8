"""The network simulator's kernels (port of `repro.kernels.netsim`).

`ops.grant` is the oracle step's age-based arbitration,
`ops.cycle_core` the fused and compact steps' arbitration core,
`ops.head_records_dense` / `ops.head_records_picked` the fused step's
record gathers and `ops.threefry_*` the draws of the PRNG
(`repro_torch.random`): the CUDA kernels in ``csrc/`` on a CUDA device,
their plain PyTorch versions (`ref.grant_ref`, `ref.cycle_core_ref`,
`ref.head_records_dense_ref`, `ref.head_records_picked_ref`,
`ref.threefry_*_ref`) on the CPU.
"""
from .ops import (cycle_core, grant, head_records_dense,
                  head_records_picked)
from .ref import (cycle_core_ref, grant_ref, head_records_dense_ref,
                  head_records_picked_ref)

__all__ = ["cycle_core", "cycle_core_ref", "grant", "grant_ref",
           "head_records_dense", "head_records_dense_ref",
           "head_records_picked", "head_records_picked_ref"]
