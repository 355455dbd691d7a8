"""Capture-signature pass: statically certify the one-capture-per-grid
promise of `repro_torch.exp.runner`, the port's counterpart of the
reference's compile-signature pass (`repro.analysis.compilepass`, whose
rule ids it keeps).

A grid (one topology x routing x traffic cell over the lane axes) runs as
ONE lane dispatch that replays one captured CUDA graph: every lane — each
(rate, seed, fault) combination — must land in one static lane dict of
one signature, or the dispatch cannot stack its lanes and the "one
capture a grid" promise breaks.  `graphs.graph_for` keys a graph on
(step, K, lane count, state signature, lane-data signature, device).
The pass rebuilds that key for each grid without a step and without
allocating the state, on the `meta` device:

  * K = `sweep.superstep(warmup + measure)`;
  * the lane count (every step runs its lanes in lockstep);
  * `graphs._state_signature` of `make_state(..., device="meta")`;
  * `graphs.lane_signature` of the lane dict `BatchedSweep._prepare_lanes`
    would build, from SHAPE PROXIES of the grid's fault specs (an empty
    `FaultSet` for a cold spec, an empty-epoch `FaultSchedule` with one
    epoch for cycle 0 and each onset and repair of a warm spec: fault
    content never changes shapes, epoch count does), with its promotion
    rule (one scheduled lane makes every lane a schedule) and its shared
    (stride-0) form when every lane holds one fault state, else stacked
    (the reference's `per_lane` rule: several fault specs, or per-seed
    sampling over several seeds).

The step object stands in the key as what makes it: the cell's topology,
routing and traffic and the cycle budget.  So two grids share a
signature only when they would share a step in the reference's sense.

  COMPILE_ONE  error: the grid's lanes do not stack into one lane dict
               (structure mismatch across lanes) — the dispatch would
               fail or fan out.
  COMPILE_SIG  info: the scenario's grids and distinct signatures, and
               the graphs `run_experiment` makes in a process that has
               not run these cells: the runner keeps one `BatchedSweep`,
               hence one step, for each distinct `cell_sweep` key, and the
               step is part of the graph key, so it makes one graph for
               each distinct cell (on CUDA it captures a chunk of at
               most `graphs.GRAPHS_KEPT` cells before it runs any of
               them, so none is evicted before it runs).  A compact run
               that escalates its capacity rung captures once more at
               the new rung; that depends on the run's occupancy and is
               not predicted (see the capacity pass).

For every registered scenario the reference's counts are grids ==
signatures (fig11: "6 grid(s), 6 distinct"), and so are the port's; the
port makes as many graphs as there are grids.
"""
from __future__ import annotations

import hashlib

from ..core.engine import graphs
from ..core.engine.state import build_lane, make_state, stack_lanes
from ..core.engine.sweep import superstep
from ..core.routing import num_vcs, share_lanes
from ..core.topology import FaultSchedule, FaultSet
from ..device import resolve_device
from ..exp.registry import get_scenario
from ..exp.spec import ExperimentSpec

PASS = "compile"
META = "meta"


def _shape_proxy(fault_spec):
    """A fault value with this spec's lane SHAPES but empty content."""
    if fault_spec.is_none:
        return None
    if fault_spec.event_cycles:
        return FaultSchedule(
            ((0, FaultSet()),)
            + tuple((c, FaultSet()) for c in fault_spec.event_cycles))
    return FaultSet()


def _sig_digest(*parts) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(repr(p).encode())
    return h.hexdigest()[:12]


def step_identity(topo, routing, traffic, cycles: int) -> tuple:
    """What a cell's step is made from, standing in for the step object
    of a graph key."""
    return (topo.kind, topo.params, tuple(sorted(routing.to_dict().items())),
            repr(traffic.to_dict()), cycles)


def graph_key_signature(net, cfg, B: int, lane_data: dict, K: int) -> tuple:
    """(K, lane count, state signature, lane signature) of the graph a
    B-lane dispatch of `lane_data` keys on."""
    NV = (num_vcs(net.meta["kind"], cfg.vc_mode, cfg.nonminimal)
          * cfg.vcs_per_class)
    state = make_state(net, cfg, NV, batch=(B,), device=META)
    return (K, B, graphs._state_signature(state),
            graphs.lane_signature(lane_data))


def grid_key(topo, routing, traffic, axes) -> tuple:
    """`graph_key_signature` of one grid's single dispatch: the key
    `graphs.graph_for` uses for it, minus the step and the device (the
    same on every device: every step runs its lanes in lockstep).
    Raises on lane-structure mismatch (the COMPILE_ONE failure)."""
    net = topo.build()
    cfg = routing.to_simconfig(axes)
    B = axes.lanes_per_grid
    cycles = axes.warmup + axes.measure

    proxies = [_shape_proxy(f) for f in axes.faults]
    if any(isinstance(p, FaultSchedule) for p in proxies):
        # the sweep's promotion rule: one scheduled lane makes every lane
        # a schedule (cold sets become 1-epoch schedules)
        proxies = [p if isinstance(p, FaultSchedule)
                   else FaultSchedule(((0, p or FaultSet()),))
                   for p in proxies]
    per_lane = (len(axes.faults) > 1
                or any(f.per_seed and not f.is_none and len(axes.seeds) > 1
                       for f in axes.faults))
    per_fault = [build_lane(net, cfg, p, device=META) for p in proxies]
    if per_lane:
        # lane order: faults x rates x seeds
        reps = B // len(per_fault)
        lane_data = stack_lanes([fl for fl in per_fault
                                 for _ in range(reps)])
    else:
        lane_data = share_lanes(per_fault[0], B)
    return graph_key_signature(net, cfg, B, lane_data, superstep(cycles))


def grid_signature(topo, routing, traffic, axes) -> str:
    """The capture signature of one grid's single dispatch: its step's
    identity and its `grid_key`."""
    cycles = axes.warmup + axes.measure
    return _sig_digest(step_identity(topo, routing, traffic, cycles),
                       grid_key(topo, routing, traffic, axes))


def runner_graphs(spec: ExperimentSpec) -> int:
    """The graphs `run_experiment(spec)` makes in a process that has not
    run these cells: one for each distinct cell (see the module
    docstring)."""
    return len({(t, r, f) for t in spec.topologies for r in spec.routings
                for f in spec.traffics})


def check_spec(spec: ExperimentSpec, origin: str, report, *,
               device=None) -> None:
    """Run the capture-signature checks on one constructed spec; the
    prediction is for `device`."""
    device = resolve_device(device)
    sigs: dict = {}
    ok = True
    for topo in spec.topologies:
        for routing in spec.routings:
            for traffic in spec.traffics:
                where = (f"{origin} [{topo.label} x {routing.label} "
                         f"x {traffic.label}]")
                try:
                    sig = grid_signature(topo, routing, traffic,
                                         spec.axes)
                except Exception as e:
                    ok = False
                    report.add(
                        PASS, "COMPILE_ONE", "error", where,
                        f"grid lanes do not stack into one graph key: "
                        f"{type(e).__name__}: {e}")
                    continue
                sigs.setdefault(sig, []).append(where)
    if ok and sigs:
        n_grids = sum(len(v) for v in sigs.values())
        made = runner_graphs(spec)
        report.add(
            PASS, "COMPILE_SIG", "info", origin,
            f"{n_grids} grid(s), {len(sigs)} distinct capture "
            f"signature(s): every grid's lanes form one graph key; "
            f"{n_grids - len(sigs)} grid(s) share an earlier cell's "
            f"signature; run_experiment makes {made} graph(s) on "
            f"{device.type}, one for each distinct cell (its step is "
            f"part of the key)")


def check_scenario(name: str, report, **kw) -> None:
    check_spec(get_scenario(name), f"scenario:{name}", report, **kw)
