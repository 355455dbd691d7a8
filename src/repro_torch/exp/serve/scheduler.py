"""Signature bucketing and the fairness policy of the serve loop (port of
`repro.exp.serve.scheduler`).

Every submitted `ExperimentSpec` lowers to per-cell lane units exactly
the way `repro_torch.exp.runner` lowers a batch run (same cell order, same
lane order, same memoized fault sampling), and each unit is tagged with
its compile-signature bucket:

    BucketKey = (topology, routing, traffic, warmup, measure, epochs)

Everything a window graph's signature can depend on is in the key —
the step (topology x routing x traffic), the cycle budget, and the
epoch-stacked lane form (0 = cold; P >= 1 = warm schedules padded to P
epochs).  Sweep seeds are deliberately NOT in the key: the engine step
never reads `cfg.seed` (lane PRNG keys are per-lane data), so the
bucket's `BatchedSweep` normalizes it to 0 and requests that differ only
in seeds share one graph.  Lanes from any mix of tenants that land in
one bucket can be packed into one device-filling dispatch
(`packer.Pack`) and hit the same cached CUDA graph — total captures ==
number of distinct buckets while they fit `graphs.GRAPHS_KEPT`.

Fairness: pending units queue per bucket in global admission order
(`seq`).  When session slots are bounded (`max_active`), candidate
packs are activated lowest-(tenant-load, seq) first — a tenant with
fewer active sessions wins a free slot even if a flood of earlier
submissions from a big tenant is still queued, so small tenants age
ahead instead of starving.  Active sessions then advance round-robin,
one window per round each, which bounds any request's completion time
by its own cycle budget regardless of backlog.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

from ...core.simulator import SimConfig
from ...core.topology import FaultSchedule
from ...device import resolve_device
from ..runner import _fault_rows, cells
from ..spec import ExperimentSpec, RoutingSpec, TopologySpec, TrafficSpec

# Serve-side sweep cache: one `BatchedSweep` per bucket signature AND
# device (seed-normalized, unlike the runner's per-spec cache) so every
# request of a bucket reuses one step — the precondition for CUDA-graph
# cache hits across tenants.  A sweep is bound to its device, so the
# device is part of the key.
_SERVE_SWEEPS: dict = {}


def clear_serve_caches() -> None:
    """Drop the serve sweep cache (tests / memory); the runner caches
    are separate (`repro_torch.exp.clear_caches`)."""
    _SERVE_SWEEPS.clear()


@dataclass(frozen=True)
class BucketKey:
    """The compiled-signature equivalence class of a lane."""

    topology: TopologySpec
    routing: RoutingSpec
    traffic: TrafficSpec
    warmup: int
    measure: int
    epochs: int = 0     # 0 = cold fault sets; P >= 1 = epoch-stacked to P

    @property
    def label(self) -> str:
        tag = f"{self.topology.label}/{self.routing.label}" \
              f"/{self.traffic.label}/c{self.warmup}+{self.measure}"
        return tag + (f"/warm{self.epochs}" if self.epochs else "")


def bucket_cfg(key: BucketKey) -> SimConfig:
    """The bucket's engine config: the cell's `SimConfig` with the seed
    normalized to 0 (the step never reads it — per-lane PRNG keys are
    lane data — so seed-only-different requests share one graph).  Like
    the reference's it carries no reaper park age (`cfg.reap_age` 0), so
    a served spec runs its reaper only through `REPRO_REAP_AGE`."""
    r = key.routing
    return SimConfig(
        pkt_len=r.pkt_len, buf_pkts=r.buf_pkts, srcq_pkts=r.srcq_pkts,
        vcs_per_class=r.vcs_per_class, warmup=key.warmup,
        measure=key.measure, vc_mode=r.vc_mode, route_mode=r.route_mode,
        ugal_threshold=r.ugal_threshold, seed=0, grant_impl=r.grant_impl,
        step_impl=r.step_impl)


def bucket_sweep(key: BucketKey, device=None):
    """The bucket's (memoized) `BatchedSweep` on `device` — one step per
    signature and device, shared by every request and pack of the
    bucket."""
    from ...core.engine.sweep import BatchedSweep
    device = resolve_device(device)
    skey = (key.topology, key.routing, key.traffic, key.warmup,
            key.measure, device)
    sweep = _SERVE_SWEEPS.get(skey)
    if sweep is None:
        net = key.topology.build()
        sweep = _SERVE_SWEEPS[skey] = BatchedSweep(
            net, bucket_cfg(key), key.traffic.resolve(net), device=device)
    return sweep


@dataclass(eq=False)
class LaneUnit:
    """One lane of one request's cell: the packing/accounting unit."""

    seq: int            # global admission order (fairness/aging)
    rid: int
    tenant: str
    cell: int           # cell index within the request's spec
    lane: int           # lane index within the cell (runner lane order)
    bucket: BucketKey
    rate: float         # offered flits/cycle/chip
    seed: int
    fset: object        # composed FaultSet | FaultSchedule | None
    fault: str          # fault spec label (record identity)

    @property
    def key(self) -> tuple:
        return (self.rid, self.cell, self.lane)

    def triple(self) -> tuple:
        return (self.rate, self.seed, self.fset)


def lower_request(spec: ExperimentSpec, rid: int, tenant: str,
                  seq0: int) -> tuple[list[LaneUnit], list[dict]]:
    """Lower a spec to lane units + per-cell record metadata, replicating
    the batch runner's lowering bit-for-bit: same `cells()` order, same
    `(fault x rate x seed)` lane order, same memoized fault sampling —
    so a unit's per-lane math is identical no matter which path runs it.
    """
    axes = spec.axes
    rates, seeds = list(axes.rates), list(axes.seeds)
    units: list[LaneUnit] = []
    cells_meta: list[dict] = []
    seq = seq0
    for ci, cell in enumerate(cells(spec)):
        cells_meta.append(dict(
            topology=cell.topology.label, topo_kind=cell.topology.kind,
            pattern=cell.traffic.label, route_mode=cell.routing.route_mode,
            vc_mode=cell.routing.vc_mode))
        frows = _fault_rows(spec, cell.topology, cell.net,
                            cell.routing.vc_mode)
        # the cell's lane form: warm if ANY lane carries a schedule, with
        # every lane padded to the cell's max epoch count — exactly what
        # the batch runner's `_prepare_lanes` + `stack_lanes` produce
        epochs = max((len(f.epochs) for row in frows for f in row
                      if isinstance(f, FaultSchedule)), default=0)
        bucket = BucketKey(cell.topology, cell.routing, cell.traffic,
                           axes.warmup, axes.measure, epochs)
        li = 0
        for fi, fspec in enumerate(axes.faults):
            for r in rates:
                for si, s in enumerate(seeds):
                    units.append(LaneUnit(
                        seq=seq, rid=rid, tenant=tenant, cell=ci,
                        lane=li, bucket=bucket, rate=r, seed=s,
                        fset=frows[fi][si], fault=fspec.label))
                    seq += 1
                    li += 1
    return units, cells_meta


@dataclass
class Scheduler:
    """Per-bucket FIFO queues + the tenant-aware activation policy."""

    pack: int
    buckets: dict = field(default_factory=dict)   # BucketKey -> deque

    def add(self, units) -> None:
        for u in units:
            self.buckets.setdefault(u.bucket, deque()).append(u)

    @property
    def pending(self) -> int:
        return sum(len(q) for q in self.buckets.values())

    def _candidates(self) -> list:
        """One candidate pack per non-empty bucket: its oldest up-to-
        `pack` pending units (FIFO within the bucket)."""
        out = []
        for key, q in self.buckets.items():
            if q:
                out.append((key, [q[i] for i in range(min(self.pack,
                                                          len(q)))]))
        return out

    def take_packs(self, tenant_active: dict, slots: int | None) -> list:
        """Pop up to `slots` packs (None = every pending unit), picking
        lowest (tenant-load, oldest-seq) first.  A pack's tenant load is
        the MINIMUM of its members' active-session counts: packing with
        a loaded tenant never penalizes the idle one whose lanes age in
        the same bucket."""
        active = dict(tenant_active)
        out = []
        while slots is None or slots > 0:
            cand = self._candidates()
            if not cand:
                break
            key, units = min(
                cand, key=lambda c: (min(active.get(u.tenant, 0)
                                         for u in c[1]),
                                     c[1][0].seq))
            q = self.buckets[key]
            for _ in units:
                q.popleft()
            out.append((key, units))
            for u in units:
                active[u.tenant] = active.get(u.tenant, 0) + 1
            if slots is not None:
                slots -= 1
        return out

    def export(self) -> list:
        """Pending units as (rid, cell, lane, seq) rows, bucket-FIFO
        order flattened by seq — the checkpoint bookkeeping form."""
        rows = [(u.rid, u.cell, u.lane, u.seq)
                for q in self.buckets.values() for u in q]
        return [list(r) for r in sorted(rows, key=lambda r: r[3])]
