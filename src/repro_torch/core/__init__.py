"""Core library of the port: topology construction, the analytical and
cost models, routing with its deadlock proofs, traffic patterns and the
lane-batched flit-level simulator (port of `repro.core`; the
topology-aware collectives are not ported yet)."""
from . import analytical, cost_model, engine, routing, simulator
from . import topology, traffic
from .topology import (CH_TYPE_NAMES, Network, SwitchDragonflyParams,
                       SwitchlessParams, build_switch_dragonfly,
                       build_switchless)
from .engine import BatchedSweep, SimState, SweepResult
from .simulator import SimConfig, SimResult, Simulator

__all__ = [
    "analytical", "cost_model", "engine", "routing", "simulator",
    "topology", "traffic", "CH_TYPE_NAMES", "Network",
    "SwitchDragonflyParams", "SwitchlessParams", "build_switch_dragonfly",
    "build_switchless", "BatchedSweep", "SimState", "SweepResult",
    "SimConfig", "SimResult", "Simulator",
]
