"""Lower an `ExperimentSpec` onto the port's batch engine: port of
`repro.exp.runner`.

`run_experiment(spec)` iterates the outer-product cells
(topology x routing x traffic) and runs each cell's whole lane grid
(faults x rates x seeds) as ONE `BatchedSweep.run_lanes` dispatch, in two
passes over chunks of at most `graphs.GRAPHS_KEPT` cells: first every
cell of the chunk is prepared and its CUDA graphs captured
(`BatchedSweep.warm_compile`), so no cell's `wall_s` holds a capture;
then the cells run.  The chunks keep every cell's graph in the graph
cache until it runs (no cell captures twice) and bound the graphs held
between the passes.  Cells that share an identical step (same topology,
routing, traffic, cycle budget and device) reuse one `BatchedSweep`
through a process-wide cache, so re-running a spec captures nothing
while its cells fit `graphs.GRAPHS_KEPT`; a spec with more cells than
that captures once a cell on each run.

Device placement, the reference's rule (`device=None` resolves to CUDA,
or raises without it; tests pass ``device="cpu"``): with one device in
`host_devices(device)` every cell runs there.  With N > 1 devices
(several cards, or REPRO_HOST_DEVICES=N logical devices) a spec of at
least N cells ROUND-ROBINS them, cell i pinned to device ``i % N``,
except cells on networks of more than `rr_max_channels` channels, which
stay unpinned (placed by the sweep, like any ``device=None`` dispatch);
a spec of fewer cells than devices leaves every cell unpinned, so each
grid spreads its lanes over the devices.  `GridResult.device` and
`placement` report what ran.  On several cards every cell of a chunk is
issued before any is read (the reference's passes 2 and 3), so the
cards run together; on one card (logical devices share it) each cell
runs and is read in turn, so each `wall_s` is that cell's own run.
Either way the rows are the single-device run's: placement never
changes a counter.

`cells(spec)` exposes the same lowering without running anything.
"""
from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np

from .. import env_int
from ..core.engine import graphs
from ..core.engine.sweep import BatchedSweep, SweepResult
from ..core.simulator import SimConfig, SimResult
from ..core.topology import Network, final_faults
from ..core.traffic import TrafficPattern
from ..device import host_devices, physical_device, resolve_device
from .spec import (ExperimentSpec, FaultSpec, RoutingSpec, SweepAxes,
                   TopologySpec, TrafficSpec)

# One `BatchedSweep` (hence one step, hence one cached graph) per distinct
# cell ON ONE DEVICE: a sweep is bound to its device, so the key holds
# the device beside the specs (a CPU and a CUDA run of one spec in one
# process must not share a sweep).
_SWEEP_CACHE: dict = {}
# Sampled fault sets, keyed by (topology, fault spec, vc_mode, lane seed):
# host data, shared by every device and every cell with that vc_mode.
_FAULT_CACHE: dict = {}


def rr_max_channels() -> int:
    """`REPRO_RR_MAX_CHANNELS` (default 1,024): a cell whose network has
    more channels than this is not round-robined onto a device of its
    own; it stays unpinned, so paper-scale cells do not run side by side
    (the reference measured overlapped paper-scale cells slower than
    serial ones)."""
    return env_int("REPRO_RR_MAX_CHANNELS", 1024)


def clear_caches() -> None:
    """Drop the sweep, fault-sample, and built-network caches (tests /
    memory)."""
    from . import spec as _spec
    _SWEEP_CACHE.clear()
    _FAULT_CACHE.clear()
    _spec._NET_CACHE.clear()


class Cell(NamedTuple):
    """One lowered outer-product cell of an experiment."""

    topology: TopologySpec
    routing: RoutingSpec
    traffic: TrafficSpec
    net: Network
    cfg: SimConfig
    pattern: TrafficPattern


def cells(spec: ExperimentSpec):
    """Yield the lowered (net, cfg, pattern) cells of `spec`, in run
    order (topology-major, then routing, then traffic)."""
    for topo in spec.topologies:
        net = topo.build()
        for routing in spec.routings:
            cfg = routing.to_simconfig(spec.axes)
            for traffic in spec.traffics:
                yield Cell(topo, routing, traffic, net, cfg,
                           traffic.resolve(net))


@dataclass
class GridResult:
    """One cell's (faults x rates x seeds) grid of `SimResult`s."""

    topology: TopologySpec
    routing: RoutingSpec
    traffic: TrafficSpec
    rates: list
    seeds: list
    fault_labels: list          # [F]
    fault_fracs: list           # [F] mean failed-link fraction over seeds
    results: list               # [F][R][S] of SimResult
    compile_count: int = 0      # CUDA graphs the grid captured (on the CPU
                                # 1, the step it ran through)
    wall_s: float = 0.0         # run wall (captures excluded)
    compile_s: float = 0.0      # warm-up + capture seconds (0.0 on reuse)
    placement: str = "single"   # the grid's dispatch (sweep.LaneRun)
    pad_fraction: float = 0.0   # ghost share of its dispatched state
    grant_form: str = "two_pass"   # the reference's form (fused.grant_form)
    occupancy_peak: int = 0     # max live request rows over the grid
    compact_capacity: int = 0   # compact ladder rung (0 = dense step)
    superstep: int = 1          # K, the cycles a superstep advances
    escalations: int = 0        # capacity-ladder reruns (compact step)
    escalation_compiles: int = 0   # captures spent on abandoned rungs
    device: str | None = None   # the device the cell was pinned to (None:
                                # placed by its sweep)

    def result(self, fault_idx: int, rate_idx: int,
               seed_idx: int = 0) -> SimResult:
        return self.results[fault_idx][rate_idx][seed_idx]

    def sweep_result(self, fault_idx: int = 0) -> SweepResult:
        """One fault row as a `SweepResult` (rate x seed grid)."""
        return SweepResult(rates=list(self.rates), seeds=list(self.seeds),
                           results=self.results[fault_idx],
                           compile_count=self.compile_count,
                           wall_s=self.wall_s, placement=self.placement,
                           pad_fraction=self.pad_fraction,
                           grant_form=self.grant_form,
                           occupancy_peak=self.occupancy_peak,
                           compact_capacity=self.compact_capacity,
                           superstep=self.superstep,
                           escalations=self.escalations,
                           escalation_compiles=self.escalation_compiles)


@dataclass
class ExperimentResult:
    """All grids of one experiment plus flat, seed-averaged records;
    `device` is the device the grids ran on."""

    spec: ExperimentSpec
    grids: list = field(default_factory=list)
    device: str | None = None

    @property
    def wall_s(self) -> float:
        return sum(g.wall_s for g in self.grids)

    @property
    def compile_s(self) -> float:
        return sum(g.compile_s for g in self.grids)

    @property
    def compile_counts(self) -> list:
        return [g.compile_count for g in self.grids]

    @property
    def max_compiles_per_grid(self) -> int:
        return max(self.compile_counts, default=0)

    def rows(self) -> list:
        """Seed-averaged records, one per (grid, fault, rate), the
        reference's fields; `wall_s` is the grid's wall amortized over
        its rows."""
        out = []
        for g in self.grids:
            F, R = len(g.fault_labels), len(g.rates)
            dt = g.wall_s / max(F * R, 1)
            for fi in range(F):
                for ri, res in enumerate(g.sweep_result(fi)
                                         .mean_over_seeds()):
                    out.append(dict(
                        scenario=self.spec.name,
                        topology=g.topology.label,
                        topo_kind=g.topology.kind,
                        pattern=g.traffic.label,
                        pattern_name=g.traffic.pattern,
                        pattern_params=dict(g.traffic.params),
                        route_mode=g.routing.route_mode,
                        vc_mode=g.routing.vc_mode,
                        fault=g.fault_labels[fi],
                        fault_frac=g.fault_fracs[fi],
                        offered=g.rates[ri],
                        throughput=res.throughput_per_chip,
                        latency=res.avg_latency,
                        delivered_pkts=res.delivered_pkts,
                        generated_pkts=res.generated_pkts,
                        dropped_pkts=res.dropped_pkts,
                        stranded_pkts=res.stranded_pkts,
                        stranded_mean=res.stranded_mean,
                        reaped_pkts=res.reaped_pkts,
                        avg_hops_by_type=res.avg_hops_by_type,
                        compile_count=g.compile_count,
                        placement=g.placement,
                        pad_fraction=g.pad_fraction,
                        grant_form=g.grant_form,
                        occupancy_peak=res.occupancy_peak,
                        compact_capacity=g.compact_capacity,
                        superstep=g.superstep,
                        escalations=g.escalations,
                        escalation_compiles=g.escalation_compiles,
                        wall_s=dt))
        return out


def _fault_rows(spec: ExperimentSpec, topo: TopologySpec, net: Network,
                vc_mode: str):
    """[F][S] composed fault sets (None = pristine), memoized."""
    rows = []
    for f in spec.axes.faults:
        row = []
        for s in spec.axes.seeds:
            key = (topo, f, vc_mode, s if f.per_seed else None)
            if key not in _FAULT_CACHE:
                _FAULT_CACHE[key] = f.sample(net, vc_mode, s)
            row.append(_FAULT_CACHE[key])
        rows.append(row)
    return rows


def cell_sweep(cell: Cell, axes: SweepAxes, device=None) -> BatchedSweep:
    """The cached `BatchedSweep` that runs `cell` on `device` (made on a
    miss): one per (cell specs, cycle budget, first seed, device)."""
    dev = resolve_device(device)
    key = (cell.topology, cell.routing, cell.traffic, axes.warmup,
           axes.measure, axes.seeds[0], dev)
    sweep = _SWEEP_CACHE.get(key)
    if sweep is None:
        sweep = _SWEEP_CACHE[key] = BatchedSweep(
            cell.net, cell.cfg, cell.pattern, device=dev)
    return sweep


def run_experiment(spec: ExperimentSpec, verbose: bool = False,
                   device=None) -> ExperimentResult:
    """Run every grid of `spec` on `device` and, with several devices, on
    its `host_devices` (see the module docstring); each grid is one
    batched dispatch (at most one capture a grid and card, none on
    reuse)."""
    dev = resolve_device(device)
    result = ExperimentResult(spec, device=str(dev))
    all_cells = list(cells(spec))
    devs = host_devices(dev)
    # round-robin cells onto devices only when there are enough cells to
    # occupy them; with fewer cells than devices each grid spreads its
    # lanes over all of them instead
    rr = len(devs) > 1 and len(all_cells) >= len(devs)
    pins = [devs[i % len(devs)]
            if rr and c.net.num_channels <= rr_max_channels() else None
            for i, c in enumerate(all_cells)]
    cards = len({physical_device(d) for d in devs})
    for lo in range(0, len(all_cells), graphs.GRAPHS_KEPT):
        hi = lo + graphs.GRAPHS_KEPT
        _run_chunk(spec, all_cells[lo:hi], pins[lo:hi], dev, cards > 1,
                   result, verbose)
    return result


def _run_chunk(spec, chunk, pins, dev, overlap, result, verbose) -> None:
    """Both passes over at most `graphs.GRAPHS_KEPT` cells (`pins` their
    devices), their grids appended to `result`; `overlap` issues every
    cell before reading any."""
    axes = spec.axes
    rates, seeds = list(axes.rates), list(axes.seeds)
    R, S, F = len(rates), len(seeds), len(axes.faults)
    # pass 1: lower each cell's grid and capture its graphs, before any
    # cell of the chunk runs, so no cell's wall_s holds a capture
    plans = []
    for cell, pin in zip(chunk, pins):
        sweep = cell_sweep(cell, axes, dev)
        frows = _fault_rows(spec, cell.topology, cell.net,
                            cell.routing.vc_mode)
        lanes = [(r, s, frows[fi][si])
                 for fi in range(F)
                 for r in rates
                 for si, s in enumerate(seeds)]
        plans.append((cell, sweep, pin,
                      sweep.warm_compile(lanes, device=pin)))

    def issue(cell, sweep, pin, plan):
        if verbose:
            where = pin if pin is not None else plan.placement
            print(f"[exp:{spec.name}] {cell.topology.label} "
                  f"{cell.routing.label} {cell.traffic.label}: "
                  f"{len(plan.lanes)} lanes on {where} "
                  f"(compiles={plan.compile_count}) ...",
                  file=sys.stderr, flush=True)
        return sweep.run_lanes_async(plan=plan)

    # pass 2: run and materialise, every cell issued first on several
    # cards, each cell in turn on one
    if overlap:
        pending = [(p[0], p[2], issue(*p)) for p in plans]
        runs = [(cell, pin, pend.finish()) for cell, pin, pend in pending]
    else:
        runs = ((p[0], p[2], issue(*p).finish()) for p in plans)
    for cell, pin, run in runs:
        flat, fsets = run.results, run.fault_sets
        results = [[[flat[(fi * R + ri) * S + si] for si in range(S)]
                    for ri in range(R)] for fi in range(F)]
        fracs = [float(np.mean(
            [0.0 if f is None
             else final_faults(f).frac_links_failed(cell.net)
             for f in fsets[fi * R * S:(fi * R * S) + S]]))
            for fi in range(F)]
        result.grids.append(GridResult(
            topology=cell.topology, routing=cell.routing,
            traffic=cell.traffic, rates=rates, seeds=seeds,
            fault_labels=[f.label for f in axes.faults],
            fault_fracs=fracs, results=results,
            compile_count=run.compile_count, wall_s=run.wall_s,
            compile_s=run.compile_s, placement=run.placement,
            pad_fraction=run.pad_fraction, grant_form=run.grant_form,
            occupancy_peak=run.occupancy_peak,
            compact_capacity=run.compact_capacity,
            superstep=run.superstep, escalations=run.escalations,
            escalation_compiles=run.escalation_compiles,
            device=None if pin is None else str(pin)))
        if verbose:
            print(f"[exp:{spec.name}]   {cell.topology.label} "
                  f"{cell.routing.label} {cell.traffic.label} done in "
                  f"{run.wall_s:.1f}s (compiles={run.compile_count}, "
                  f"compile_s={run.compile_s:.1f})",
                  file=sys.stderr, flush=True)
