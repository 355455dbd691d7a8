"""Declarative experiment API of the port (port of `repro.exp`).

Specs describe the paper's scenario grids (topology x traffic x routing x
faults x rates x seeds) as frozen, JSON-round-trippable dataclasses whose
JSON is the reference's; the registry names the paper's Fig. 10-15 grids
plus benchmark/smoke grids; the runner lowers any spec onto the port's
batch engine with at most one CUDA-graph capture per grid.

    from repro_torch.exp import get_scenario, run_experiment
    result = run_experiment(get_scenario("fig10a"))        # on CUDA
    for row in result.rows(): ...

CLI: ``python -m repro_torch.exp.run --scenario smoke``.
"""
from .spec import (ExperimentSpec, FaultSpec, ReaperSpec, RoutingSpec,
                   SweepAxes, TopologySpec, TrafficSpec)
from .registry import (get_scenario, list_scenarios, register_scenario)
from .runner import (Cell, ExperimentResult, GridResult, cells,
                     clear_caches, run_experiment)
from .provenance import provenance, spec_hash
from .roofline import RooflineSpec
from .fleet import FleetSpec, FleetResult, fleet_inbox, run_fleet

__all__ = [
    "ExperimentSpec", "FaultSpec", "ReaperSpec", "RoutingSpec",
    "SweepAxes", "TopologySpec", "TrafficSpec", "RooflineSpec",
    "FleetSpec", "FleetResult", "fleet_inbox", "run_fleet",
    "get_scenario", "list_scenarios", "register_scenario",
    "Cell", "ExperimentResult", "GridResult", "cells", "clear_caches",
    "run_experiment", "provenance", "spec_hash",
]

# `repro_torch.exp.serve` (the persistent service) and
# `repro_torch.exp.windows` (the shared JSONL schema) are imported as
# submodules on demand — serving pulls in the checkpoint layer.
