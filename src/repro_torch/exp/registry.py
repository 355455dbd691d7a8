"""Named-scenario registry: port of `repro.exp.registry`.  The paper's
Fig. 10-15 evaluation grids, the benchmark grids (`bench_sweep`,
`bench_faults`), and tiny smoke variants, all as registered
`ExperimentSpec`s — every scenario of the reference, by the same name,
with the same `fast=` builders and the same `to_dict()`.

Each scenario has a public builder (`fig11_spec(fast=False, g=41)` etc.)
for non-default scales; the registry holds the default (fast, CPU-sized)
instances.  `register_scenario` is the extension point every future
scenario PR plugs into — a registered spec is addressable by name from
tests and the CLI (`python -m repro_torch.exp.run --scenario X`), and
runs from its serialized form.
"""
from __future__ import annotations

from .spec import (ExperimentSpec, FaultSpec, RoutingSpec, SweepAxes,
                   TopologySpec, TrafficSpec)

_SCENARIOS: dict = {}
_BUILDERS: dict = {}


def register_scenario(spec: ExperimentSpec, *, replace: bool = False,
                      builder=None) -> ExperimentSpec:
    """Register `spec` under `spec.name`; duplicate names raise unless
    `replace=True`.  `builder` is the scenario's scale factory
    (`builder(fast=...) -> ExperimentSpec`), which backs the CLI's
    `--fast` / `--full` axis; scenarios without one only run at their
    registered default scale."""
    if spec.name in _SCENARIOS and not replace:
        raise ValueError(f"scenario {spec.name!r} already registered")
    _SCENARIOS[spec.name] = spec
    if builder is not None:
        _BUILDERS[spec.name] = builder
    return spec


def get_scenario(name: str, fast: bool | None = None) -> ExperimentSpec:
    """The registered spec (default), or the scenario rebuilt through its
    `*_spec(fast=...)` builder when `fast` is given."""
    if name not in _SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; registered: "
                       f"{list_scenarios()}")
    if fast is None:
        return _SCENARIOS[name]
    builder = _BUILDERS.get(name)
    if builder is None:
        raise KeyError(
            f"scenario {name!r} has no fast/full builder; run it without "
            f"--fast/--full (builders exist for: {sorted(_BUILDERS)})")
    return builder(fast=fast)


def list_scenarios() -> list:
    return sorted(_SCENARIOS)


# ---------------------------------------------------------------------------
# Paper figures (Sec. V).  `fast` trims cycle counts (and for the global
# figures, W-group counts) to single-CPU-core scale while preserving the
# orderings the paper claims; `fast=False` is the paper-scale grid.
# ---------------------------------------------------------------------------

def _cycles(fast, fast_wm, full_wm=(2000, 8000)):
    wm = fast_wm if fast else full_wm
    return dict(warmup=wm[0], measure=wm[1])


def fig10a_spec(fast: bool = True) -> ExperimentSpec:
    """Fig. 10(a-b): intra-C-group uniform / bit-reverse."""
    return ExperimentSpec(
        name="fig10a",
        topologies=TopologySpec.switchless(
            a=1, b=1, m=2, n=6, noc=2, g=1, label="switchless-cgroup"),
        traffics=(TrafficSpec("uniform"), TrafficSpec("bit_reverse")),
        routings=RoutingSpec(vcs_per_class=4),
        axes=SweepAxes(rates=(1.0, 2.0, 3.0, 3.6),
                       **_cycles(fast, (400, 1200))),
        notes="paper Fig. 10(a-b): saturation ~3.0 flits/cycle/chip")


def fig10cf_spec(fast: bool = True) -> ExperimentSpec:
    """Fig. 10(c-f): intra-W-group, switchless 1B/2B vs switch-based."""
    return ExperimentSpec(
        name="fig10cf",
        topologies=(
            TopologySpec.switchless(a=2, b=4, m=2, n=6, noc=2, g=1,
                                    label="switchless-1B"),
            TopologySpec.switchless(a=2, b=4, m=2, n=6, noc=2, g=1,
                                    cg_bw_mult=2, label="switchless-2B"),
            TopologySpec.dragonfly(t=4, l=7, gl=1, g=1,
                                   label="switch-based")),
        traffics=(TrafficSpec("uniform"), TrafficSpec("bit_transpose")),
        routings=RoutingSpec(vcs_per_class=2),
        axes=SweepAxes(rates=(0.5, 1.0, 1.5, 2.0),
                       **_cycles(fast, (400, 1200))))


def fig11_spec(fast: bool = True, g: int | None = None) -> ExperimentSpec:
    """Fig. 11: global uniform / bit-reverse on the radix-16 network.
    Full scale is g=41 (1312 chips); fast uses g=11 (352 chips)."""
    g = g or (11 if fast else None)
    return ExperimentSpec(
        name="fig11",
        topologies=(
            TopologySpec.preset("radix16_switchless", g=g,
                                label="switchless-1B"),
            TopologySpec.preset("radix16_switchless", g=g, cg_bw_mult=2,
                                label="switchless-2B"),
            TopologySpec.preset("radix16_dragonfly", g=g,
                                label="switch-based")),
        traffics=(TrafficSpec("uniform"), TrafficSpec("bit_reverse")),
        routings=RoutingSpec(vcs_per_class=2),
        axes=SweepAxes(rates=(0.4, 0.7, 1.0), **_cycles(fast, (300, 900))))


def fig12_spec(fast: bool = True) -> ExperimentSpec:
    """Fig. 12: radix-32-class scalability (reduced W-groups on CPU)."""
    g = 5 if fast else 29
    return ExperimentSpec(
        name="fig12",
        topologies=(
            TopologySpec.preset("radix32_switchless", g=g,
                                label="switchless-1B"),
            TopologySpec.preset("radix32_switchless", g=g, cg_bw_mult=2,
                                label="switchless-2B"),
            TopologySpec.preset("radix32_dragonfly", g=g,
                                label="switch-based")),
        traffics=TrafficSpec("uniform"),
        routings=RoutingSpec(vcs_per_class=2),
        axes=SweepAxes(rates=(0.4, 0.8),
                       **_cycles(fast, (250, 600), (1000, 4000))))


def fig13_spec(fast: bool = True) -> ExperimentSpec:
    """Fig. 13: minimal vs non-minimal (VAL / UGAL) on hotspot + WC,
    full-size radix-16 switch-less network."""
    return ExperimentSpec(
        name="fig13",
        topologies=TopologySpec.preset("radix16_switchless",
                                       label="switchless"),
        traffics=(TrafficSpec("worst_case"),
                  TrafficSpec("hotspot",
                              params=(("num_hot", 4), ("seed", 0)))),
        routings=(RoutingSpec(route_mode="min", vcs_per_class=2),
                  RoutingSpec(route_mode="val", vcs_per_class=2),
                  RoutingSpec(route_mode="ugal", vcs_per_class=2)),
        axes=SweepAxes(rates=(0.2, 0.5), **_cycles(fast, (300, 800))))


def fig14_specs(fast: bool = True) -> tuple:
    """Fig. 14: ring AllReduce within C-group and W-group.  Three specs
    because vcs_per_class and the rate grid differ per topology class."""
    cyc = _cycles(fast, (400, 1200))
    ring = (TrafficSpec("ring_allreduce",
                        params=(("bidirectional", False),)),
            TrafficSpec("ring_allreduce",
                        params=(("bidirectional", True),)))
    cg_rates = (1.0, 2.0, 3.0, 3.8)
    wg_rates = (0.6, 1.0, 1.6, 2.2)
    return (
        ExperimentSpec(
            name="fig14_cgroup_switchless",
            topologies=TopologySpec.switchless(
                a=1, b=1, m=2, n=6, noc=2, g=1, label="cgroup-switchless"),
            traffics=ring, routings=RoutingSpec(vcs_per_class=4),
            axes=SweepAxes(rates=cg_rates, **cyc)),
        ExperimentSpec(
            name="fig14_cgroup_switch",
            topologies=TopologySpec.dragonfly(t=4, l=0, gl=0, g=1,
                                              label="cgroup-switch"),
            traffics=ring, routings=RoutingSpec(vcs_per_class=2),
            axes=SweepAxes(rates=cg_rates, **cyc)),
        ExperimentSpec(
            name="fig14_wgroup",
            topologies=(
                TopologySpec.switchless(a=2, b=4, m=2, n=6, noc=2, g=1,
                                        label="wgroup-switchless"),
                TopologySpec.switchless(a=2, b=4, m=2, n=6, noc=2, g=1,
                                        cg_bw_mult=2,
                                        label="wgroup-switchless-2B"),
                TopologySpec.dragonfly(t=4, l=7, gl=1, g=1,
                                       label="wgroup-switch")),
            traffics=ring, routings=RoutingSpec(vcs_per_class=2),
            axes=SweepAxes(rates=wg_rates, **cyc)))


def fig15_spec(fast: bool = True) -> ExperimentSpec:
    """Fig. 15: hop counts for the energy model (min vs VAL, g=9)."""
    return ExperimentSpec(
        name="fig15",
        topologies=(
            TopologySpec.preset("radix16_switchless", g=9,
                                label="switchless"),
            TopologySpec.preset("radix16_dragonfly", g=9,
                                label="switch-based")),
        traffics=TrafficSpec("uniform"),
        routings=(RoutingSpec(route_mode="min", vcs_per_class=2),
                  RoutingSpec(route_mode="val", vcs_per_class=2)),
        axes=SweepAxes(rates=(0.3,),
                       **_cycles(fast, (300, 800), (1000, 4000))))


# ---------------------------------------------------------------------------
# Benchmark + smoke grids
# ---------------------------------------------------------------------------

def bench_sweep_spec(rates=(0.2, 0.4, 0.6, 0.8, 1.0, 1.2, 1.4, 1.6),
                     seeds=(0, 1, 2), warmup: int = 100,
                     measure: int = 500) -> ExperimentSpec:
    """The engine-perf sweep of benchmarks/bench_sweep.py."""
    return ExperimentSpec(
        name="bench_sweep",
        topologies=TopologySpec.switchless(
            a=1, b=1, m=2, n=6, noc=2, g=1, label="bench-sweep"),
        traffics=TrafficSpec("uniform"),
        routings=RoutingSpec(vcs_per_class=2),
        axes=SweepAxes(rates=rates, seeds=seeds,
                       warmup=warmup, measure=measure))


def bench_faults_spec(fracs=(0.0, 0.04, 0.08, 0.12, 0.16), seeds=(0, 1),
                      offered: float = 0.55, warmup: int = 300,
                      measure: int = 1500) -> ExperimentSpec:
    """The degraded-wafer grid of benchmarks/bench_faults.py: one
    independently sampled link-fault set per (failure rate, seed) lane
    (FaultSpec i seeds its stream at 1000*i + lane seed, the historical
    convention)."""
    return ExperimentSpec(
        name="bench_faults",
        topologies=TopologySpec.switchless(
            a=2, b=2, m=2, n=4, noc=2, g=5, label="bench-faults"),
        traffics=TrafficSpec("uniform"),
        routings=RoutingSpec(route_mode="min", vc_mode="updown",
                             vcs_per_class=2),
        axes=SweepAxes(
            rates=(offered,), seeds=seeds,
            faults=tuple(FaultSpec(kind="links", frac=f, seed=i)
                         for i, f in enumerate(fracs)),
            warmup=warmup, measure=measure))


def smoke_spec() -> ExperimentSpec:
    """A seconds-scale scenario for smoke runs and quick local checks."""
    return ExperimentSpec(
        name="smoke",
        topologies=TopologySpec.switchless(
            a=1, b=1, m=2, n=6, noc=2, g=1, label="smoke-cgroup"),
        traffics=TrafficSpec("uniform"),
        routings=RoutingSpec(vcs_per_class=2),
        axes=SweepAxes(rates=(0.5, 1.5), warmup=50, measure=200))


def smoke_fused_spec() -> ExperimentSpec:
    """The smoke grid on the fused cycle step (`step_impl="fused"`; in the
    reference it doubles as the channel-sharding smoke, which the port
    does not have)."""
    return ExperimentSpec(
        name="smoke_fused",
        topologies=TopologySpec.switchless(
            a=1, b=1, m=2, n=6, noc=2, g=3, label="smoke-fused"),
        traffics=TrafficSpec("uniform"),
        routings=RoutingSpec(vcs_per_class=2, step_impl="fused"),
        axes=SweepAxes(rates=(0.5, 1.5), warmup=50, measure=200),
        notes="smoke on the fused step (channel-shardable)")


def smoke_compact_spec() -> ExperimentSpec:
    """The smoke grid on the occupancy-compacted step
    (`step_impl="compact"`): live rows are compacted into a
    capacity-C active set before arbitration (C starts at a
    `fused.capacity_ladder` rung; breaches escalate to the next rung
    with a bit-identical whole-grid rerun)."""
    return ExperimentSpec(
        name="smoke_compact",
        topologies=TopologySpec.switchless(
            a=1, b=1, m=2, n=6, noc=2, g=3, label="smoke-compact"),
        traffics=TrafficSpec("uniform"),
        routings=RoutingSpec(vcs_per_class=2, step_impl="compact"),
        axes=SweepAxes(rates=(0.5, 1.5), warmup=50, measure=200),
        notes="smoke on the occupancy-compacted step (capacity ladder)")


def smoke_fig10a_spec() -> ExperimentSpec:
    """Fig. 10(a) topology + patterns at smoke scale: the tier-1 parity
    fixture (run_experiment vs legacy Simulator.sweep, lane-for-lane)."""
    spec = fig10a_spec(fast=True)
    return ExperimentSpec(
        name="smoke_fig10a",
        topologies=spec.topologies, traffics=spec.traffics,
        routings=spec.routings,
        axes=SweepAxes(rates=(1.0, 3.0), seeds=(0, 1),
                       warmup=61, measure=251),
        notes="fig10a at smoke scale (tier-1 parity fixture)")


def smoke_faults_spec() -> ExperimentSpec:
    """A tiny fault grid (tier-1 compile-accounting fixture)."""
    return ExperimentSpec(
        name="smoke_faults",
        topologies=TopologySpec.switchless(
            a=2, b=2, m=2, n=4, noc=2, g=5, label="smoke-faults"),
        traffics=TrafficSpec("uniform"),
        routings=RoutingSpec(route_mode="min", vc_mode="updown",
                             vcs_per_class=2),
        axes=SweepAxes(rates=(0.5,), seeds=(0, 1),
                       faults=(FaultSpec(),
                               FaultSpec(kind="links", frac=0.08, seed=1)),
                       warmup=67, measure=241))


# ---------------------------------------------------------------------------
# Warm faults (time-varying `FaultSchedule`s: links die mid-run)
# ---------------------------------------------------------------------------

def smoke_warm_faults_spec() -> ExperimentSpec:
    """Warm-fault smoke: a quarter of the global links die at cycle 151
    while traffic is in flight, adaptive (UGAL) routing re-routes the
    survivors.  The fixture of the time-varying fault path (one grid, one
    compile, 2-epoch schedules).  Global-only faults keep the
    schedule routable under ALL THREE vc_modes, which is what the
    per-epoch deadlock-freedom test sweeps."""
    return ExperimentSpec(
        name="smoke_warm_faults",
        topologies=TopologySpec.switchless(
            a=2, b=2, m=2, n=4, noc=2, g=5, label="smoke-warm"),
        traffics=TrafficSpec("uniform"),
        routings=RoutingSpec(route_mode="ugal", vc_mode="baseline",
                             vcs_per_class=1),
        axes=SweepAxes(rates=(0.5,), seeds=(0, 1),
                       faults=(FaultSpec(),
                               FaultSpec(kind="links", types=("global",),
                                         frac=0.25, seed=2, onsets=(151,))),
                       warmup=71, measure=311),
        notes="warm faults: 25% of global links die mid-run (smoke)")


def yield_curve_spec(fast: bool = True, fracs=(0.15, 0.3, 0.45),
                     offered: float = 0.8) -> ExperimentSpec:
    """Yield-vs-throughput on the paper's radix-32-class network (2B
    on-wafer bandwidth): a growing fraction of the global links dies
    MID-RUN under adversarial (worst-case) traffic, minimal vs. adaptive
    (UGAL) routing.  Minimal routing pays the dead parallel links of each
    W-group pair directly; the fault-aware adaptive stage re-routes
    around them, so delivered throughput degrades more gracefully —
    `benchmarks/bench_yield.py` records the two curves in
    BENCH_yield.json.  Fast scale: g=3 W-groups, short cycles; full:
    g=9, paper-scale cycle budget."""
    g = 3 if fast else 9
    wm = (120, 480) if fast else (800, 3200)
    onset = wm[0] + wm[1] // 4
    return ExperimentSpec(
        name="yield_curve",
        topologies=TopologySpec.preset("radix32_switchless", g=g,
                                       cg_bw_mult=2,
                                       label="radix32-switchless-2B"),
        traffics=TrafficSpec("worst_case"),
        routings=(RoutingSpec(route_mode="min", vc_mode="baseline",
                              vcs_per_class=1),
                  RoutingSpec(route_mode="ugal", vc_mode="baseline",
                              vcs_per_class=1)),
        axes=SweepAxes(
            rates=(offered,), seeds=(0, 1),
            faults=(FaultSpec(),) + tuple(
                FaultSpec(kind="links", types=("global",), frac=f,
                          seed=7 + i, onsets=(onset,))
                for i, f in enumerate(fracs)),
            warmup=wm[0], measure=wm[1]),
        notes="yield curve: global links die mid-run, minimal vs adaptive")


def _register_defaults() -> None:
    register_scenario(fig10a_spec(), builder=fig10a_spec)
    register_scenario(fig10cf_spec(), builder=fig10cf_spec)
    register_scenario(fig11_spec(), builder=fig11_spec)
    register_scenario(fig12_spec(), builder=fig12_spec)
    register_scenario(fig13_spec(), builder=fig13_spec)
    for i, spec in enumerate(fig14_specs()):
        register_scenario(spec,
                          builder=lambda fast=True, _i=i: fig14_specs(fast)[_i])
    register_scenario(fig15_spec(), builder=fig15_spec)
    register_scenario(yield_curve_spec(), builder=yield_curve_spec)
    for spec in (bench_sweep_spec(), bench_faults_spec(), smoke_spec(),
                 smoke_fused_spec(), smoke_compact_spec(),
                 smoke_fig10a_spec(),
                 smoke_faults_spec(), smoke_warm_faults_spec()):
        register_scenario(spec)


_register_defaults()
