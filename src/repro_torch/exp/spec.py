"""Declarative experiment specs: port of `repro.exp.spec`.

The same frozen value objects over the port's `core` modules, so the
reference's spec JSON is the interchange format:
`ExperimentSpec.from_dict(reference_spec.to_dict()).to_dict()` equals the
reference's dict key for key, and `provenance.spec_hash` agrees across
the two packages.

The paper's evaluation is a grid of scenarios — topology variant x traffic
pattern x routing/VC mode x offered load x fault set.  An `ExperimentSpec`
names one such grid declaratively:

    spec = ExperimentSpec(
        name="fig10a",
        topologies=TopologySpec.switchless(a=1, b=1, m=2, n=6, noc=2, g=1),
        traffics=(TrafficSpec("uniform"), TrafficSpec("bit_reverse")),
        routings=RoutingSpec(vcs_per_class=4),
        axes=SweepAxes(rates=(1.0, 2.0, 3.0, 3.6), warmup=400, measure=1200))

All spec classes are frozen dataclasses: hashable (usable as cache keys),
equality-comparable, validated at construction (bad route/VC pairings,
out-of-range fault rates, unknown patterns all raise `ValueError` before
anything runs), and JSON round-trippable —
`ExperimentSpec.from_dict(spec.to_dict()) == spec` holds exactly, because
free-form parameter dicts are canonicalized to sorted key/value pair
tuples at construction.

Lowering semantics (implemented by `repro_torch.exp.runner`):

  * `topologies x routings x traffics` is the OUTER product: each cell
    gets its own engine step (different nets / VC schemes / samplers
    capture separately, identical cells share one captured graph);
  * `axes.faults x axes.rates x axes.seeds` is the LANE product: inside a
    cell, every combination is one lane of a single
    `BatchedSweep.run_lanes` dispatch — at most one capture per grid.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from ..core import topology as T
from ..core import traffic as TR
from ..core.engine.arbitrate import GRANT_IMPLS
from ..core.engine.step import STEP_IMPLS
from ..core.simulator import SimConfig
from ..core.topology import FaultSchedule, FaultSet, Network

SCHEMA_VERSION = 1

TOPO_KINDS = ("switchless", "dragonfly")
ROUTE_MODES = ("min", "val", "val_restricted", "ugal")
VC_MODES = ("baseline", "updown", "updown_merged")
FAULT_KINDS = ("none", "links", "routers", "clusters")
LINK_TYPES = {"mesh": T.MESH, "local": T.LOCAL, "global": T.GLOBAL}


def _pairs(params) -> tuple:
    """Canonical sorted (key, value) pair tuple for free-form params —
    hashable, order-independent, JSON round-trip stable."""
    d = dict(params)
    out = []
    for k in sorted(d):
        v = d[k]
        if isinstance(v, (list, tuple)):
            v = tuple(v)
        out.append((str(k), v))
    return tuple(out)


def _seq(x, cls) -> tuple:
    """Coerce a single spec / dict or a sequence of them to a tuple of
    `cls` instances (singletons are a convenience for one-axis specs)."""
    if isinstance(x, cls) or isinstance(x, dict):
        x = (x,)
    return tuple(cls.from_dict(e) if isinstance(e, dict) else e for e in x)


# ---------------------------------------------------------------------------
# Topology
# ---------------------------------------------------------------------------

_PRESETS = {
    "radix16_switchless": T.paper_radix16_switchless,
    "radix16_dragonfly": T.paper_radix16_dragonfly,
    "radix32_switchless": T.paper_radix32_switchless,
    "radix32_dragonfly": T.paper_radix32_dragonfly,
}

_NET_CACHE: dict = {}


@dataclass(frozen=True)
class TopologySpec:
    """One network variant: builder kind + full builder-params pairs.

    `params` is canonicalized through the builder's params dataclass
    (`SwitchlessParams` / `SwitchDragonflyParams`) at construction, so two
    specs naming the same network compare equal even when one spelled out
    defaults and the other didn't — and invalid parameters (unknown
    fields, `g` out of range, `h < 1`) raise here, not at build time.
    """

    kind: str
    params: tuple = ()
    label: str = ""

    def __post_init__(self):
        if self.kind not in TOPO_KINDS:
            raise ValueError(
                f"unknown topology kind {self.kind!r}; valid: {TOPO_KINDS}")
        p = self._params_obj(dict(_pairs(self.params)))
        object.__setattr__(self, "params", _pairs(dataclasses.asdict(p)))
        object.__setattr__(self, "label", self.label or self._default_label())

    def _params_obj(self, kw=None):
        cls = (T.SwitchlessParams if self.kind == "switchless"
               else T.SwitchDragonflyParams)
        try:
            p = cls(**(dict(self.params) if kw is None else kw))
        except TypeError as e:
            raise ValueError(f"bad {self.kind} params: {e}") from None
        # trigger range validation eagerly (raises ValueError)
        if self.kind == "switchless":
            p.num_wgroups
            if p.h < 1:
                raise ValueError(
                    f"h={p.h} < 1: k={p.k} too small for ab={p.ab}")
        else:
            p.num_groups
        return p

    def _default_label(self) -> str:
        d = dict(self.params)
        if self.kind == "switchless":
            tag = f"a{d['a']}b{d['b']}m{d['m']}n{d['n']}g{d['g']}"
            if d.get("cg_bw_mult", 1) > 1:
                tag += f"x{d['cg_bw_mult']}B"
        else:
            tag = f"t{d['t']}l{d['l']}gl{d['gl']}g{d['g']}"
        return f"{self.kind}-{tag}"

    @classmethod
    def switchless(cls, label: str = "", **params) -> "TopologySpec":
        return cls("switchless", _pairs(params), label)

    @classmethod
    def dragonfly(cls, label: str = "", **params) -> "TopologySpec":
        return cls("dragonfly", _pairs(params), label)

    @classmethod
    def preset(cls, name: str, label: str = "", **overrides
               ) -> "TopologySpec":
        """A paper evaluation configuration by name (`radix16_switchless`,
        `radix16_dragonfly`, `radix32_switchless`, `radix32_dragonfly`);
        `overrides` pass through to the preset factory (e.g. `g=11`,
        `cg_bw_mult=2`)."""
        if name not in _PRESETS:
            raise ValueError(
                f"unknown preset {name!r}; valid: {sorted(_PRESETS)}")
        p = _PRESETS[name](**overrides)
        kind = ("switchless" if isinstance(p, T.SwitchlessParams)
                else "dragonfly")
        return cls(kind, _pairs(dataclasses.asdict(p)), label or name)

    def build(self) -> Network:
        """Build (memoized per spec) the concrete router/channel graph."""
        net = _NET_CACHE.get(self)
        if net is None:
            p = self._params_obj()
            build = (T.build_switchless if self.kind == "switchless"
                     else T.build_switch_dragonfly)
            net = _NET_CACHE[self] = build(p, self.label)
        return net

    def to_dict(self) -> dict:
        return dict(kind=self.kind, params=dict(self.params),
                    label=self.label)

    @classmethod
    def from_dict(cls, d: dict) -> "TopologySpec":
        return cls(d["kind"], _pairs(d.get("params", {})),
                   d.get("label", ""))


# ---------------------------------------------------------------------------
# Traffic
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TrafficSpec:
    """A traffic pattern by registry name (`core.traffic.PATTERNS`)
    plus factory parameters.  Resolution always yields the normalized
    `(sample, inject_mask)` protocol — the hotspot mask travels with the
    pattern, no caller-side special-casing."""

    pattern: str
    params: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "params", _pairs(self.params))
        TR.validate_pattern_params(self.pattern, dict(self.params))

    @property
    def label(self) -> str:
        if not self.params:
            return self.pattern
        args = ",".join(f"{k}={v}" for k, v in self.params)
        return f"{self.pattern}({args})"

    def resolve(self, net: Network) -> TR.TrafficPattern:
        return TR.make_pattern(net, self.pattern, **dict(self.params))

    def to_dict(self) -> dict:
        return dict(pattern=self.pattern, params=dict(self.params))

    @classmethod
    def from_dict(cls, d: dict) -> "TrafficSpec":
        return cls(d["pattern"], _pairs(d.get("params", {})))


# ---------------------------------------------------------------------------
# Routing / router microarchitecture
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ReaperSpec:
    """Age-based router-death reaper policy (docs/faults.md).

    A packet whose destination died mid-run parks on the stranded gauge
    and holds its buffer slot forever; the reaper DROPS such a parked
    packet once its age reaches `park_age` cycles (counted to the
    `reaped` counter, so conservation stays exact:
    generated == delivered + dropped + reaped + in-flight).  `park_age`
    0 (the default) disables the reaper — stranding keeps its historical
    park-forever semantics and the step compiles no reap logic.  The
    env knob `REPRO_REAP_AGE` supplies a process-wide default when the
    config leaves the reaper off (`repro_torch.env_int`)."""

    park_age: int = 0

    def __post_init__(self):
        if self.park_age < 0:
            raise ValueError(
                f"park_age must be >= 0 (0 disables the reaper), got "
                f"{self.park_age}")

    def to_dict(self) -> dict:
        return dict(park_age=self.park_age)

    @classmethod
    def from_dict(cls, d: dict) -> "ReaperSpec":
        return cls(**d)


@dataclass(frozen=True)
class RoutingSpec:
    """Routing algorithm + VC scheme + router microarchitecture knobs.

    Construction enforces the route/VC compatibility the deadlock proofs
    rely on: `updown_merged` merges the intermediate- and destination-
    W-group VCs, so only restricted misroutes (`min` / `val_restricted`)
    keep its channel-dependency graph acyclic.
    """

    route_mode: str = "min"
    vc_mode: str = "baseline"
    vcs_per_class: int = 2
    ugal_threshold: int = 3
    pkt_len: int = 4
    buf_pkts: int = 8
    srcq_pkts: int = 64
    # arbitration grant implementation: the reference's names "jnp" and
    # "pallas" are both valid and run ONE function in the port
    # (`kernels.netsim.ops.grant`: the CUDA kernel on the card, its plain
    # version on the CPU)
    grant_impl: str = "jnp"
    # cycle-step implementation: "jnp" (phase-pipeline oracle) | "fused"
    # (route-once-per-hop fused step, the perf path; supports channel
    # sharding via REPRO_CHANNEL_SHARDS)
    step_impl: str = "jnp"
    # router-death reaper policy (park-forever off by default)
    reaper: ReaperSpec = ReaperSpec()

    def __post_init__(self):
        if isinstance(self.reaper, dict):
            object.__setattr__(self, "reaper",
                               ReaperSpec.from_dict(self.reaper))
        if not isinstance(self.reaper, ReaperSpec):
            raise ValueError(
                f"reaper must be a ReaperSpec, got {self.reaper!r}")
        if self.grant_impl not in GRANT_IMPLS:
            raise ValueError(
                f"unknown grant_impl {self.grant_impl!r}; "
                f"valid: {GRANT_IMPLS}")
        if self.step_impl not in STEP_IMPLS:
            raise ValueError(
                f"unknown step_impl {self.step_impl!r}; "
                f"valid: {STEP_IMPLS}")
        if self.route_mode not in ROUTE_MODES:
            raise ValueError(
                f"unknown route_mode {self.route_mode!r}; "
                f"valid: {ROUTE_MODES}")
        if self.vc_mode not in VC_MODES:
            raise ValueError(
                f"unknown vc_mode {self.vc_mode!r}; valid: {VC_MODES}")
        if (self.vc_mode == "updown_merged"
                and self.route_mode not in ("min", "val_restricted")):
            raise ValueError(
                "vc_mode 'updown_merged' merges the intermediate- and "
                "destination-W-group VCs; unrestricted misrouting "
                f"(route_mode {self.route_mode!r}) would close a CDG "
                "cycle — use 'min' or 'val_restricted'")
        for fld in ("vcs_per_class", "pkt_len", "buf_pkts", "srcq_pkts"):
            if getattr(self, fld) < 1:
                raise ValueError(f"{fld} must be >= 1, got "
                                 f"{getattr(self, fld)}")
        if self.ugal_threshold < 0:
            raise ValueError("ugal_threshold must be >= 0")

    @property
    def label(self) -> str:
        return f"{self.route_mode}/{self.vc_mode}"

    def to_simconfig(self, axes: "SweepAxes") -> SimConfig:
        return SimConfig(
            pkt_len=self.pkt_len, buf_pkts=self.buf_pkts,
            srcq_pkts=self.srcq_pkts, vcs_per_class=self.vcs_per_class,
            warmup=axes.warmup, measure=axes.measure,
            vc_mode=self.vc_mode, route_mode=self.route_mode,
            ugal_threshold=self.ugal_threshold, seed=axes.seeds[0],
            grant_impl=self.grant_impl, step_impl=self.step_impl,
            reap_age=self.reaper.park_age)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)   # nests reaper as a plain dict

    @classmethod
    def from_dict(cls, d: dict) -> "RoutingSpec":
        d = dict(d)
        if "reaper" in d:
            d["reaper"] = ReaperSpec.from_dict(d["reaper"])
        return cls(**d)


# ---------------------------------------------------------------------------
# Faults
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FaultSpec:
    """One sampled fault population of the degraded-wafer model.

    kind      "none" (pristine), "links" (kill ~`frac` of the fabric links
              of `types`), "routers" (kill `num` routers), "clusters"
              (kill `num_clusters` Chebyshev-`radius` defect blobs)
    seed      sampling-stream base; with `per_seed` (default) every sweep
              seed lane draws an INDEPENDENT fault set from stream
              `1000 * seed + lane_seed` (the convention of
              benchmarks/bench_faults.py), otherwise all lanes share one.
    onsets    the WARM (schedule) form: strictly increasing cycle numbers
              at which the fault population grows.  Empty (default) means
              cold faults from cycle 0; with onsets `(c1, .., ck)` the
              sampled result is a `FaultSchedule` — pristine until `c1`,
              then a monotone-growing fault set reaching the full
              population (`frac` / `num` / `num_clusters`) at `ck`, each
              epoch validated routable on top of the previous one.
    repairs   the REPAIR (shrinking) extension: strictly increasing cycle
              numbers, all past the last onset, at which the population
              shrinks again.  Repair j reverts the j-th most recent
              growth increment (LIFO — last broken, first fixed), so
              every repair epoch's fault set is one of the already-
              validated wear-out states; `len(repairs)` up to
              `len(onsets)` (equal means the wafer fully recovers).
    """

    kind: str = "none"
    frac: float = 0.0
    num: int = 0
    num_clusters: int = 1
    radius: int = 1
    types: tuple = ("mesh", "local", "global")
    seed: int = 0
    per_seed: bool = True
    onsets: tuple = ()
    repairs: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "types", tuple(self.types))
        object.__setattr__(self, "frac", float(self.frac))
        object.__setattr__(self, "onsets",
                           tuple(int(c) for c in self.onsets))
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; valid: {FAULT_KINDS}")
        if not 0.0 <= self.frac <= 1.0:
            raise ValueError(f"fault frac {self.frac} outside [0, 1]")
        if self.num < 0:
            raise ValueError(f"fault num must be >= 0, got {self.num}")
        if self.num_clusters < 1 or self.radius < 0:
            raise ValueError("need num_clusters >= 1 and radius >= 0")
        bad = set(self.types) - set(LINK_TYPES)
        if bad:
            raise ValueError(
                f"unknown link types {sorted(bad)}; valid: "
                f"{sorted(LINK_TYPES)}")
        object.__setattr__(self, "repairs",
                           tuple(int(c) for c in self.repairs))
        if self.onsets:
            if self.kind == "none":
                raise ValueError("onsets need a fault kind to schedule "
                                 "(kind='none' is pristine)")
            if any(c <= 0 for c in self.onsets):
                raise ValueError(
                    f"onset cycles must be > 0 (cycle 0 is the cold "
                    f"epoch), got {self.onsets}")
            if any(b <= a for a, b in zip(self.onsets, self.onsets[1:])):
                raise ValueError(
                    f"onset cycles must be strictly increasing: "
                    f"{self.onsets}")
        if self.repairs:
            if not self.onsets:
                raise ValueError(
                    "repairs revert warm growth increments and need "
                    "onsets to revert (a cold population has no "
                    "increment history)")
            if len(self.repairs) > len(self.onsets):
                raise ValueError(
                    f"{len(self.repairs)} repairs would revert more than "
                    f"the {len(self.onsets)} growth increment(s) sampled")
            if any(b <= a for a, b in zip(self.repairs, self.repairs[1:])):
                raise ValueError(
                    f"repair cycles must be strictly increasing: "
                    f"{self.repairs}")
            if self.repairs[0] <= self.onsets[-1]:
                raise ValueError(
                    f"repairs must start after the last onset "
                    f"({self.onsets[-1]}), got {self.repairs}")

    @property
    def is_none(self) -> bool:
        return self.kind == "none"

    @property
    def is_warm(self) -> bool:
        """True for the schedule form (mid-run fault onset/repair)."""
        return bool(self.onsets)

    @property
    def event_cycles(self) -> tuple:
        """Every mid-run epoch-swap cycle (onsets then repairs)."""
        return self.onsets + self.repairs

    @property
    def needs_updown(self) -> bool:
        """True when sampling may kill mesh/local links or routers, which
        only the up*/down* VC modes on the switch-less fabric can route
        around (`topology.validate_faults`)."""
        if self.kind == "none":
            return False
        if self.kind == "links":
            return bool(set(self.types) & {"mesh", "local"})
        return True

    @property
    def label(self) -> str:
        if self.kind == "none":
            return "pristine"
        if self.kind == "links":
            tag = f"links:{self.frac:g}"
        elif self.kind == "routers":
            tag = f"routers:{self.num}"
        else:
            tag = f"clusters:{self.num_clusters}r{self.radius}"
        if self.onsets:
            tag += "@" + ",".join(str(c) for c in self.onsets)
        if self.repairs:
            tag += "~" + ",".join(str(c) for c in self.repairs)
        return tag

    def sample(self, net: Network, vc_mode: str, lane_seed: int = 0
               ) -> FaultSet | FaultSchedule | None:
        """Draw this population for one sweep-seed lane: None for the
        pristine spec, a cold `FaultSet` without `onsets`, a warm
        `FaultSchedule` with them.  Degraded nets stay routable at every
        epoch by the samplers' greedy validation (each warm increment
        composes on top of the previous epoch via `base=`); repair
        epochs revert increments LIFO, so each shrunken state is one the
        growth phase already validated."""
        if self.kind == "none":
            return None
        rng = np.random.default_rng(
            1000 * self.seed + lane_seed if self.per_seed else self.seed)
        if not self.onsets:
            return self._sample_increment(net, vc_mode, rng, 1, 1, None)
        k = len(self.onsets)
        states = [FaultSet()]       # growth history: states[i] after onset i
        epochs = [(0, states[0])]
        for i, c in enumerate(self.onsets):
            states.append(self._sample_increment(net, vc_mode, rng,
                                                 i + 1, k, states[-1]))
            epochs.append((c, states[-1]))
        for j, c in enumerate(self.repairs):
            epochs.append((c, states[k - 1 - j]))
        return FaultSchedule(tuple(epochs))

    def _sample_increment(self, net: Network, vc_mode: str, rng,
                          i: int, k: int, base: FaultSet | None) -> FaultSet:
        """Grow the population to i/k of its full size on top of `base`
        (i == k == 1 is the cold one-shot draw)."""
        if self.kind == "links":
            types = tuple(LINK_TYPES[t] for t in self.types)
            return T.sample_link_faults(net, self.frac / k, rng,
                                        types=types, vc_mode=vc_mode,
                                        base=base)
        if self.kind == "routers":
            delta = round(self.num * i / k) - round(self.num * (i - 1) / k)
            return T.sample_router_faults(net, delta, rng, vc_mode=vc_mode,
                                          base=base)
        delta = (round(self.num_clusters * i / k)
                 - round(self.num_clusters * (i - 1) / k))
        return T.sample_cluster_faults(net, rng, num_clusters=delta,
                                       radius=self.radius, vc_mode=vc_mode,
                                       base=base)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["types"] = list(self.types)
        d["onsets"] = list(self.onsets)
        d["repairs"] = list(self.repairs)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "FaultSpec":
        return cls(**d)


# ---------------------------------------------------------------------------
# Sweep axes
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SweepAxes:
    """The lane axes of every grid: offered rates x sweep seeds x fault
    populations, plus the per-lane cycle budget."""

    rates: tuple
    seeds: tuple = (0,)
    faults: tuple = (FaultSpec(),)
    warmup: int = 2000
    measure: int = 8000

    def __post_init__(self):
        object.__setattr__(self, "rates",
                           tuple(float(r) for r in self.rates))
        object.__setattr__(self, "seeds",
                           tuple(int(s) for s in self.seeds))
        object.__setattr__(self, "faults", _seq(self.faults, FaultSpec))
        if not self.rates:
            raise ValueError("need >= 1 offered rate")
        if any(r <= 0 for r in self.rates):
            raise ValueError(f"offered rates must be > 0, got {self.rates}")
        if not self.seeds:
            raise ValueError("need >= 1 seed")
        if not self.faults:
            raise ValueError("need >= 1 fault spec (use FaultSpec() for "
                             "pristine)")
        if self.warmup < 0 or self.measure < 1:
            raise ValueError("need warmup >= 0 and measure >= 1")
        cycles = self.warmup + self.measure
        for f in self.faults:
            if f.event_cycles and max(f.event_cycles) >= cycles:
                raise ValueError(
                    f"fault spec {f.label!r} schedules an epoch swap at "
                    f"cycle {max(f.event_cycles)}, past the {cycles}-cycle "
                    f"run (warmup + measure) — the epoch would never "
                    f"activate while accounting reports its degradation")

    @property
    def lanes_per_grid(self) -> int:
        return len(self.rates) * len(self.seeds) * len(self.faults)

    def to_dict(self) -> dict:
        return dict(rates=list(self.rates), seeds=list(self.seeds),
                    faults=[f.to_dict() for f in self.faults],
                    warmup=self.warmup, measure=self.measure)

    @classmethod
    def from_dict(cls, d: dict) -> "SweepAxes":
        return cls(rates=tuple(d["rates"]),
                   seeds=tuple(d.get("seeds", (0,))),
                   faults=tuple(FaultSpec.from_dict(f)
                                for f in d.get("faults", ({"kind": "none"},))),
                   warmup=d.get("warmup", 2000),
                   measure=d.get("measure", 8000))


# ---------------------------------------------------------------------------
# The composed experiment
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ExperimentSpec:
    """One declarative experiment: outer-product cells
    (`topologies x routings x traffics`) over shared lane axes.

    Cross-axis compatibility is validated at construction: the
    switch-based Dragonfly baseline only supports the baseline VC scheme
    and GLOBAL-link faults, and mesh/local/router faults require an
    up*/down* VC mode (matching `topology.validate_faults`), so an
    invalid grid fails before any network is built.
    """

    name: str
    topologies: tuple
    traffics: tuple
    routings: tuple
    axes: SweepAxes
    notes: str = ""

    def __post_init__(self):
        if not self.name:
            raise ValueError("experiment needs a name")
        object.__setattr__(self, "topologies",
                           _seq(self.topologies, TopologySpec))
        object.__setattr__(self, "traffics", _seq(self.traffics, TrafficSpec))
        object.__setattr__(self, "routings", _seq(self.routings, RoutingSpec))
        if isinstance(self.axes, dict):
            object.__setattr__(self, "axes", SweepAxes.from_dict(self.axes))
        if not (self.topologies and self.traffics and self.routings):
            raise ValueError("need >= 1 topology, traffic, and routing spec")
        faulty = [f for f in self.axes.faults if not f.is_none]
        for topo in self.topologies:
            for r in self.routings:
                if topo.kind == "dragonfly" and r.vc_mode != "baseline":
                    raise ValueError(
                        f"vc_mode {r.vc_mode!r} is a switch-less up*/down* "
                        f"scheme; the dragonfly baseline ({topo.label}) "
                        "only supports 'baseline'")
            for f in faulty:
                if f.kind == "clusters" and topo.kind != "switchless":
                    raise ValueError(
                        "clustered (wafer-defect) faults only exist on the "
                        "switch-less topology")
                if f.needs_updown:
                    if topo.kind == "dragonfly":
                        raise ValueError(
                            "the switch-based Dragonfly fault model "
                            "supports GLOBAL-link faults only "
                            f"(fault spec {f.label!r})")
                    for r in self.routings:
                        if r.vc_mode == "baseline":
                            raise ValueError(
                                f"fault spec {f.label!r} can kill "
                                "mesh/local links or routers, which "
                                "vc_mode 'baseline' cannot route around — "
                                "use 'updown' or 'updown_merged'")

    @property
    def num_grids(self) -> int:
        return (len(self.topologies) * len(self.routings)
                * len(self.traffics))

    @property
    def num_lanes(self) -> int:
        return self.num_grids * self.axes.lanes_per_grid

    def with_axes(self, **kw) -> "ExperimentSpec":
        """A copy with some `SweepAxes` fields replaced (e.g. trimmed
        cycle counts for a smoke run)."""
        return dataclasses.replace(
            self, axes=dataclasses.replace(self.axes, **kw))

    def to_dict(self) -> dict:
        return dict(
            version=SCHEMA_VERSION,
            name=self.name,
            topologies=[t.to_dict() for t in self.topologies],
            traffics=[t.to_dict() for t in self.traffics],
            routings=[r.to_dict() for r in self.routings],
            axes=self.axes.to_dict(),
            notes=self.notes)

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentSpec":
        version = d.get("version", SCHEMA_VERSION)
        if version != SCHEMA_VERSION:
            raise ValueError(
                f"unsupported experiment schema version {version} "
                f"(this build reads {SCHEMA_VERSION})")
        return cls(
            name=d["name"],
            topologies=tuple(TopologySpec.from_dict(t)
                             for t in d["topologies"]),
            traffics=tuple(TrafficSpec.from_dict(t) for t in d["traffics"]),
            routings=tuple(RoutingSpec.from_dict(r) for r in d["routings"]),
            axes=SweepAxes.from_dict(d["axes"]),
            notes=d.get("notes", ""))
