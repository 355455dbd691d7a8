"""Wafer-fleet Monte Carlo: yield distributions over sampled defect maps
(port of `repro.exp.fleet`).

A `FleetSpec` describes a FLEET of wafers — hundreds of independently
sampled defect maps and fault/repair schedules (clustered manufacturing
defects, wear-out onset curves, router death, repair epochs) — all
running the same workload at the same offered load.  It lowers onto the
existing experiment machinery by the identity

    one Monte Carlo sample == one sweep-seed lane

Every fault level is a `FaultSpec` with `per_seed=True`, so seed lane
`s` draws its OWN defect map from stream ``1000 * level_seed + s``; the
fleet's `samples` count simply becomes the seed axis.  The whole fleet
is therefore one `ExperimentSpec` whose grid runs through
`BatchedSweep.run_lanes`' one-capture lane dispatch: hundreds of
distinct defect maps and repair schedules share ONE graph per
(topology x routing x traffic) cell (fault data is lane data;
heterogeneous epoch counts pad to one `[B, P, ...]` shape), and the
per-grid `compile_count` in the results certifies it.

`run_fleet` computes the yield distribution per fault level —
p10/p50/p90 of delivered throughput over the sampled wafers, the yield
fraction against a pristine-median threshold, and the reliability
counters (stranded / reaped) the router-death reaper maintains.
`fleet_inbox` re-emits the same fleet as a multi-tenant
`repro_torch.exp.serve` inbox (one tenant per wafer), which
makes the fleet double as a serve-scheduler stress test: every wafer's
lanes land in the same signature bucket and pack across tenants.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass

import numpy as np

from .spec import (ExperimentSpec, FaultSpec, RoutingSpec, SweepAxes,
                   TopologySpec, TrafficSpec, _seq)
from .runner import ExperimentResult, run_experiment


@dataclass(frozen=True)
class FleetSpec:
    """A Monte Carlo wafer fleet (see module docstring).

    samples     number of independently sampled wafers (defect maps);
                becomes the sweep-seed axis, so every non-pristine level
                must sample `per_seed` (validated here — a shared map
                would collapse the distribution to one point).
    levels      the fault levels to distribute over, each a `FaultSpec`
                (typically: a pristine reference, clustered defects with
                wear-out `onsets`, router death, `repairs` epochs).
    offered     offered load (flits/cycle/chip) every wafer runs at.
    yield_threshold
                a wafer "yields" when its throughput reaches this
                fraction of the pristine level's median throughput
                (only meaningful when a pristine level is present).
    """

    name: str
    topology: TopologySpec
    routing: RoutingSpec
    levels: tuple
    samples: int = 8
    traffic: TrafficSpec = TrafficSpec("uniform")
    offered: float = 0.5
    warmup: int = 100
    measure: int = 400
    yield_threshold: float = 0.5
    notes: str = ""

    def __post_init__(self):
        if isinstance(self.topology, dict):
            object.__setattr__(self, "topology",
                               TopologySpec.from_dict(self.topology))
        if isinstance(self.routing, dict):
            object.__setattr__(self, "routing",
                               RoutingSpec.from_dict(self.routing))
        if isinstance(self.traffic, dict):
            object.__setattr__(self, "traffic",
                               TrafficSpec.from_dict(self.traffic))
        object.__setattr__(self, "levels", _seq(self.levels, FaultSpec))
        if not self.name:
            raise ValueError("fleet needs a name")
        if self.samples < 1:
            raise ValueError(f"need >= 1 sample, got {self.samples}")
        if not self.levels:
            raise ValueError("need >= 1 fault level (use FaultSpec() "
                             "for a pristine reference)")
        for f in self.levels:
            if not f.is_none and not f.per_seed:
                raise ValueError(
                    f"fleet level {f.label!r} has per_seed=False: every "
                    "sample would draw the SAME defect map, collapsing "
                    "the Monte Carlo distribution to one point")
        if not 0.0 < self.yield_threshold <= 1.0:
            raise ValueError(
                f"yield_threshold must be in (0, 1], got "
                f"{self.yield_threshold}")

    def to_experiment(self) -> ExperimentSpec:
        """The fleet as one standard `ExperimentSpec` grid: sample i is
        seed lane i."""
        return ExperimentSpec(
            name=self.name,
            topologies=self.topology,
            traffics=self.traffic,
            routings=self.routing,
            axes=SweepAxes(rates=(self.offered,),
                           seeds=tuple(range(self.samples)),
                           faults=self.levels,
                           warmup=self.warmup, measure=self.measure),
            notes=self.notes or f"wafer-fleet Monte Carlo "
                                f"({self.samples} samples)")

    def to_dict(self) -> dict:
        return dict(
            name=self.name, topology=self.topology.to_dict(),
            routing=self.routing.to_dict(),
            levels=[f.to_dict() for f in self.levels],
            samples=self.samples, traffic=self.traffic.to_dict(),
            offered=self.offered, warmup=self.warmup,
            measure=self.measure, yield_threshold=self.yield_threshold,
            notes=self.notes)

    @classmethod
    def from_dict(cls, d: dict) -> "FleetSpec":
        return cls(**dict(d, levels=tuple(d["levels"])))


@dataclass
class FleetResult:
    """Per-level yield distributions plus the underlying experiment."""

    fleet: FleetSpec
    experiment: ExperimentResult
    records: list       # one dict per (grid cell, fault level)


def _quantiles(xs) -> dict:
    q10, q50, q90 = np.percentile(np.asarray(xs, dtype=float),
                                  [10.0, 50.0, 90.0])
    return dict(p10=float(q10), p50=float(q50), p90=float(q90))


def run_fleet(fleet: FleetSpec, verbose: bool = False,
              device=None) -> FleetResult:
    """Run the whole fleet (one batched dispatch per grid cell) and fold
    the per-wafer results into yield-distribution records.

    Each record covers one (cell, fault level) pair over all `samples`
    wafers: throughput/latency quantiles, the yield fraction against
    the pristine median, exact stranded max/mean, total reaped packets,
    and the compile count of the grid the samples shared; `device` as in
    `run_experiment`."""
    exp = run_experiment(fleet.to_experiment(), verbose=verbose,
                         device=device)
    records = []
    for g in exp.grids:
        # the pristine reference median for the yield threshold (None
        # when the fleet carries no pristine level)
        base_p50 = None
        for fi, f in enumerate(fleet.levels):
            if f.is_none:
                base_p50 = _quantiles(
                    [r.throughput_per_chip
                     for r in g.results[fi][0]])["p50"]
                break
        for fi, f in enumerate(fleet.levels):
            row = g.results[fi][0]              # [samples] SimResults
            thr = [r.throughput_per_chip for r in row]
            rec = dict(
                fleet=fleet.name,
                topology=g.topology.label,
                route_mode=g.routing.route_mode,
                vc_mode=g.routing.vc_mode,
                pattern=g.traffic.label,
                level=f.label,
                fault_frac=g.fault_fracs[fi],
                samples=len(row),
                offered=fleet.offered,
                throughput=_quantiles(thr),
                latency=_quantiles([r.avg_latency for r in row]),
                stranded_max=max(r.stranded_pkts for r in row),
                stranded_mean=float(np.mean([r.stranded_pkts
                                             for r in row])),
                reaped_total=sum(r.reaped_pkts for r in row),
                dropped_total=sum(r.dropped_pkts for r in row),
                compile_count=g.compile_count,
                placement=g.placement,
                grant_form=g.grant_form,
                wall_s=g.wall_s)
            if base_p50 is not None and base_p50 > 0:
                cut = fleet.yield_threshold * base_p50
                rec["yield_frac"] = float(
                    np.mean([t >= cut for t in thr]))
                rec["yield_threshold"] = fleet.yield_threshold
            records.append(rec)
    return FleetResult(fleet=fleet, experiment=exp, records=records)


def fleet_inbox(fleet: FleetSpec, directory: str,
                tenant_prefix: str = "wafer") -> list:
    """Write the fleet as a multi-tenant `repro_torch.exp.serve` inbox: one
    submission file per sampled wafer, each a single-seed slice of the
    fleet's experiment under its own tenant.  Every wafer's lanes carry
    the same (topology, routing, traffic, cycles) signature, so the
    serve scheduler's signature-bucketed packer packs them ACROSS
    tenants into shared graphs — the fleet doubles as a multi-tenant
    packing stress test.  Returns the written paths:

        python -m repro_torch.exp.serve --inbox DIR --out results.jsonl
    """
    exp = fleet.to_experiment()
    os.makedirs(directory, exist_ok=True)
    width = len(str(fleet.samples - 1))
    paths = []
    for si in range(fleet.samples):
        sub = dataclasses.replace(
            exp, name=f"{fleet.name}-s{si}",
            axes=dataclasses.replace(exp.axes, seeds=(si,)))
        path = os.path.join(directory,
                            f"{fleet.name}-{si:0{width}d}.json")
        with open(path, "w") as fh:
            json.dump({"tenant": f"{tenant_prefix}{si}",
                       "spec": sub.to_dict()}, fh)
        paths.append(path)
    return paths


# ---------------------------------------------------------------------------
# Registered fleets
# ---------------------------------------------------------------------------

def smoke_fleet(fast: bool = True) -> FleetSpec:
    """The smoke fleet: a full reliability lifecycle at smoke scale.

    Three fault levels on the small up*/down*-routable wafer — a
    pristine reference, clustered wear-out that GROWS over two onsets
    and then REPAIRS (one shrink epoch), and mid-run router death with
    the reaper draining the stranded population.  8 samples fast, 128
    full (a real distribution)."""
    samples = 8 if fast else 128
    wm = (61, 251) if fast else (200, 1200)
    c = wm[0] + wm[1]
    onsets = (c // 4, c // 2)
    repairs = (3 * c // 4,)
    return FleetSpec(
        name="smoke_fleet",
        topology=TopologySpec.switchless(
            a=2, b=2, m=2, n=4, noc=2, g=5, label="fleet-smoke"),
        routing=RoutingSpec(route_mode="min", vc_mode="updown",
                            vcs_per_class=2,
                            reaper={"park_age": c // 4}),
        levels=(
            FaultSpec(),
            FaultSpec(kind="clusters", num_clusters=2, radius=1, seed=3,
                      onsets=onsets, repairs=repairs),
            FaultSpec(kind="routers", num=2, seed=5,
                      onsets=(onsets[0],)),
        ),
        samples=samples, offered=0.45,
        warmup=wm[0], measure=wm[1],
        notes="CI wafer-fleet smoke: clustered wear-out + repair + "
              "router death with the reaper on")


def _register() -> None:
    from .registry import register_scenario
    # registering the LOWERED experiment makes the scenario CLI and the
    # serve registry path cover the fleet with no fleet-specific plumbing
    register_scenario(smoke_fleet().to_experiment())


_register()
