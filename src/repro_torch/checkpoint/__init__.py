"""Atomic on-disk snapshots of simulation state (npz + manifest,
retention-K) — the persistence layer behind `repro_torch.exp.serve` and
any long `LaneSession` run that must survive preemption (port of
`repro.checkpoint`)."""
from .checkpointing import Checkpointer, restore_sim_state, save_sim_state

__all__ = ["Checkpointer", "restore_sim_state", "save_sim_state"]
