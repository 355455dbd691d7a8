"""Core library of the port: topology construction, the analytical and
cost models, routing with its deadlock proofs, traffic patterns, the
lane-batched flit-level simulator and the topology-aware collectives on
`torch.distributed` (port of `repro.core`)."""
from . import analytical, collectives, cost_model, engine, routing
from . import simulator
from . import topology, traffic
from .topology import (CH_TYPE_NAMES, Network, SwitchDragonflyParams,
                       SwitchlessParams, build_switch_dragonfly,
                       build_switchless)
from .engine import BatchedSweep, SimState, SweepResult
from .simulator import SimConfig, SimResult, Simulator

__all__ = [
    "analytical", "collectives", "cost_model", "engine", "routing",
    "simulator", "topology", "traffic", "CH_TYPE_NAMES", "Network",
    "SwitchDragonflyParams", "SwitchlessParams", "build_switch_dragonfly",
    "build_switchless", "BatchedSweep", "SimState", "SweepResult",
    "SimConfig", "SimResult", "Simulator",
]
