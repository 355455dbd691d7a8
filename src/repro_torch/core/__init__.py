"""Core library of the port: topology construction, routing, traffic
patterns and the lane-batched flit-level simulator (port of `repro.core`;
the analytical and cost models are not ported yet)."""
from . import engine, routing, simulator, topology, traffic
from .topology import (CH_TYPE_NAMES, Network, SwitchDragonflyParams,
                       SwitchlessParams, build_switch_dragonfly,
                       build_switchless)
from .engine import BatchedSweep, SimState, SweepResult
from .simulator import SimConfig, SimResult, Simulator

__all__ = [
    "engine", "routing", "simulator", "topology", "traffic",
    "CH_TYPE_NAMES", "Network", "SwitchDragonflyParams", "SwitchlessParams",
    "build_switch_dragonfly", "build_switchless", "BatchedSweep",
    "SimState", "SweepResult", "SimConfig", "SimResult", "Simulator",
]
