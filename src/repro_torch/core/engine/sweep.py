"""Batched load-latency sweeps: every (rate x seed x fault) lane advances
in lockstep through one step, the lanes stacked on a leading dimension.

Port of the single-device part of `repro.core.engine.sweep`:

    sweep = BatchedSweep(net, cfg, pattern, device="cuda")
    grid = sweep.run(rates=[0.2, 0.4, ...], seeds=(0, 1))
    grid.result(i, j)            # SimResult for (rates[i], seeds[j])
    grid.mean_over_seeds()       # list[SimResult], one per rate
    grid.saturation_throughput() # scalar, seed-averaged

Lane (i, j) reproduces the reference lane bit for bit: its key chain is
the reference's and the lanes never mix.

The cycle loop (`loop=`):

- "graph", the default: K-cycle supersteps through an `engine.graphs`
  `CycleGraph`.  On CUDA each is a captured CUDA graph, the counterpart
  of the reference's AOT executable cache: one capture for each (step,
  K, lane count, lane-data signature, device), `compile_counter()` counts
  them and `clear_aot_cache()` drops them; `compile_s` holds the warm-up
  and capture seconds and `wall_s` excludes them.  On the CPU the same
  supersteps run eagerly;
- "eager": one step a host-int cycle (`step.run_scan`), the parity
  yardstick, only when asked for.

K is `superstep(cycles)` (REPRO_SUPERSTEP, falling back to 1 when it does
not divide the cycles); every substep keeps its own absolute cycle and
zeroes the stats on the device at the end of warmup, so any K gives the
counters of K = 1.  `lane_form` picks how the lanes run: in lockstep, or
one after another outside the cycle loop (the reference's
`_scan_lanes_seq`), each as a one-lane dispatch of the same loop.

The compact step's capacity ladder is ported: a run whose live-row
census outgrew its rung is re-run whole at the next rung
(`_PendingLanes.finish`), which captures anew.

Windowed sessions (`BatchedSweep.start_lanes` -> `LaneSession`) advance
the lanes one window at a time and hold their state, keys and absolute
cycle between windows, so a service can stream counters, checkpoint and
interleave many sessions.  Each window runs only its real cycles through
the shared `CycleGraph`s (copied in, replayed, copied out): the K graph
for whole supersteps and a K = 1 graph for a tail shorter than K, so a
session costs one capture a signature, two when some window's length is
not a multiple of K.  Chained windows replay the one-shot key chain, so
`finish()` equals `run_lanes` bit for bit.

Device placement (the reference's lane mesh): with more than one device
in `host_devices` (every visible card; REPRO_HOST_DEVICES=N logical
devices, on the CPU or round-robin on the cards) a dispatch with
``device=None`` and at least `shard_min_work` lane-cycles spreads its
lanes: the lanes are padded with GHOST lanes (rate 0, lane 0's key and
fault data, dropped before the results) to a multiple of the device
count and cut into equal chunks, each chunk's state, rates, keys and
lane data on its device, each chunk replaying its own graph.  Every
chunk is issued before any is read.  Logical devices on one card share
its graphs: `CycleGraph.run` copies a chunk's state in and its counters
out in stream order, and every chunk of a card runs on that card's one
stream, so a chunk never sees another's buffers.  `compile_count` is
then one capture for each distinct (graph key, card).  An explicit
``device`` pins the whole run to that (logical) device: the runner's and
the service's round-robin.  Placement never changes a counter.

Channel sharding (REPRO_CHANNEL_SHARDS=K, fused step, ``device=None``,
at least K devices): each lane row of K devices runs the channel-sharded
step (`fused.ShardedStep`), the lanes spread over the rows as above.  A
captured CUDA graph cannot span cards, so this dispatch runs the eager
loop (one host-int cycle a step) on every device and reports
``loop="eager"``.  `pad_fraction` is the ghost share of the dispatched
state, lanes and channels together (the reference's formula).
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ... import env_int
from ... import random as jr
from ...device import host_devices, physical_device
from ...tensors import to_device
from ..routing import share_lanes
from ..topology import (FaultSchedule, FaultSet, Network, as_fault_schedule,
                        compose_faults, final_faults)
from ..traffic import as_pattern
from . import graphs
from .fused import (fused_pad, grant_form, make_compact_step,
                    make_fused_step, next_rung)
from .state import (SimState, SimStats, build_lane, make_state,
                    resolve_device, stack_lanes)
from .stats import finalize, lane_stats
# the key chains live with the cycle loop (`step.run_scan`) that draws
# them; they are re-exported here, where the reference defines them
from .step import (_key_chain, _key_chain_seq, make_step,  # noqa: F401
                   run_steps)

# the cycle loops a dispatch can run (see the module docstring)
LOOPS = ("graph", "eager")


def compile_counter() -> int:
    """CUDA graphs captured so far in this process (the reference counts
    its batched-scan compilations)."""
    return graphs.captures()


def clear_aot_cache() -> None:
    """Drop the captured CUDA graphs and their memory pools."""
    graphs.clear()


def shard_min_work() -> int:
    """Minimum (real lanes x cycles) for a dispatch to spread its lanes
    over several devices; smaller grids run on one.  REPRO_SHARD_MIN_WORK
    (default 4,096; 0 always spreads, as the sharding tests do)."""
    return env_int("REPRO_SHARD_MIN_WORK", 4096)


def channel_shards() -> int:
    """Requested channel-shard count K (REPRO_CHANNEL_SHARDS, default 1):
    honoured only by fused-step dispatches with ``device=None`` and at
    least K devices."""
    return max(env_int("REPRO_CHANNEL_SHARDS", 1), 1)


def lane_mesh(shards: int = 1, device=None) -> list | None:
    """The lane rows of a dispatch on `device`'s `host_devices`: one list
    of `shards` devices a row (the reference's 1-D ``("lanes",)`` or 2-D
    ``("lanes", "shards")`` mesh); None with one device.  `shards` must
    divide the device count."""
    devs = host_devices(device)
    nd = len(devs)
    if nd <= 1:
        return None
    if nd % shards:
        raise ValueError(f"REPRO_CHANNEL_SHARDS={shards} does not divide "
                         f"the {nd} host devices")
    return [devs[i:i + shards] for i in range(0, nd, shards)]


def _on(device: torch.device):
    """The context that makes `device` (physical) current for the launches
    of a chunk on it."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def superstep(span: int | None = None) -> int:
    """K-cycle superstep factor (REPRO_SUPERSTEP, default 1): the loop
    advances K cycles a superstep, each substep at its own absolute cycle
    with its own warmup reset and fault epoch, so any K gives the counters
    of K = 1.  `span` is the cycle count to cover; K falls back to 1 when
    it does not divide `span`."""
    k = max(env_int("REPRO_SUPERSTEP", 1), 1)
    if span is not None and span % k:
        return 1
    return k


def lane_form(step, device: torch.device) -> str:
    """The dispatch planner's lane form, "lockstep" (every lane in one
    loop) or "sequential" (one lane at a time, outside the cycle loop).
    On the CPU it is the reference's rule: sequential for the compact
    step on one device.  On CUDA every step runs in lockstep, the form
    `chip_smoke.py` measured faster at the paper's scale (PERF.md)."""
    if torch.device(device).type == "cpu" and getattr(
            step, "compact_capacity", 0):
        return "sequential"
    return "lockstep"


def _scan_lanes(step, cycles: int, reset_at: int, K: int, loop: str,
                state0, rate_pkt, keys, lanes, subs=None):
    """Advance the B lanes `cycles` cycles in lockstep through `loop`;
    returns (final counters, captures made, capture seconds).  `subs`
    is the lanes' ``[cycles, B, 2]`` subkey chain when the caller drew it
    already, else it is drawn from `keys`."""
    if subs is None:
        subs = _key_chain(keys, cycles)
    if loop == "eager":
        return (run_steps(step, 0, subs, reset_at, state0, rate_pkt,
                          lanes).stats, 0, 0.0)
    if loop != "graph":
        raise ValueError(f"unknown loop {loop!r}; valid: {LOOPS}")
    graph, captured = graphs.graph_for(step, K, state0, rate_pkt, lanes)
    stats = graph.run(state0, rate_pkt, lanes, reset_at, subs)
    return stats, int(captured), graph.capture_s if captured else 0.0


def _lane_args(b: int, state0, rate_pkt, keys, lanes) -> tuple:
    """Lane b of a dispatch's (state, rates, keys, lane data), each as a
    one-lane view (a shared lane dict stays stride-0; no keys stay
    None)."""
    one = lambda x: x[b:b + 1]
    st = SimState(stats=SimStats(**{k: one(v) for k, v
                                    in vars(state0.stats).items()}),
                  **{k: one(v) for k, v in vars(state0).items()
                     if k != "stats"})
    return (st, one(rate_pkt), None if keys is None else one(keys),
            {k: one(v) for k, v in lanes.items()})


def _scan_lanes_seq(step, cycles: int, reset_at: int, K: int, loop: str,
                    state0, rate_pkt, keys, lanes, subs=None):
    """`_scan_lanes` with the lane axis OUTSIDE the cycle loop: each lane
    runs the whole loop as a one-lane dispatch (one graph serves every
    lane of a signature).  Lanes are independent and keep their key
    chains, so the counters are the lockstep form's bit for bit."""
    if subs is None:
        subs = _key_chain(keys, cycles)
    stats, made, capture_s = [], 0, 0.0
    for b in range(int(rate_pkt.shape[0])):
        st, m, c = _scan_lanes(step, cycles, reset_at, K, loop,
                               *_lane_args(b, state0, rate_pkt, keys,
                                           lanes), subs=subs[:, b:b + 1])
        stats.append(st)
        made, capture_s = made + m, capture_s + c
    return (SimStats(**{k: torch.cat([getattr(st, k) for st in stats])
                        for k in vars(stats[0])}), made, capture_s)


def run_scan_batched(step, cycles: int, reset_at: int, state0, rate_pkt,
                     keys, lanes, per_lane_faults: bool) -> SimState:
    """Single-device batched scan, the reference's stable public entry
    point: the B lanes of `state0` (offered packet rates `rate_pkt` [B],
    keys [B, 2]) advance `cycles` cycles in lockstep from cycle 0, the
    stats zeroed after cycle `reset_at`; returns the final `SimState`,
    every field.  `lanes` is lane-stacked ([B, ...]) with
    `per_lane_faults`, else one lane dict shared by every lane.

    It draws the key chain `BatchedSweep` draws and runs the loop it runs
    on the lanes' device: `run_steps` on the CPU; on CUDA a `CycleGraph`
    of one cycle (captured once a signature), which copies the state in
    and back out around its replays.  `state0` is left as it was (the
    reference donates it)."""
    B = int(rate_pkt.shape[0])
    fl = lanes if per_lane_faults else share_lanes(lanes, B)
    state = graphs.state_like(state0)
    graphs.copy_state(state, state0)
    subs = _key_chain(keys, cycles)
    if rate_pkt.device.type != "cuda":
        return run_steps(step, 0, subs, reset_at, state, rate_pkt, fl)
    graph, _ = graphs.graph_for(step, 1, state, rate_pkt, fl)
    graph.advance(state, rate_pkt, fl, reset_at, subs, 0)
    return state


def offered_to_rate_pkt(offered_per_chip: float, cfg,
                        terms_per_chip: float) -> float:
    """Offered flits/cycle/chip -> per-terminal packet-generation rate;
    raises when the load needs more than one packet per terminal per
    cycle."""
    rate = offered_per_chip / cfg.pkt_len / terms_per_chip
    if rate > 1.0 + 1e-9:
        raise ValueError(
            f"offered {offered_per_chip}/chip needs per-terminal packet "
            f"rate {rate:.2f} > 1")
    return rate


class LaneRun(NamedTuple):
    """The outcome of one `run_lanes` dispatch."""

    results: list          # one SimResult per lane, in lane order
    wall_s: float          # run wall time (device synchronised), captures
                           # excluded
    compile_s: float       # warm-up + capture seconds (0.0 on a cache hit,
                           # on the CPU and on the eager loop)
    # CUDA graphs this dispatch captured; on the CPU and on the eager loop
    # 1, the step the grid ran through
    compile_count: int
    fault_sets: list       # composed per-lane fault states (None=pristine)
    placement: str = "single"   # "single" | "lanes:L" | "lanes:L,shards:K"
    pad_fraction: float = 0.0   # ghost share of the dispatched state
    grant_form: str = "two_pass"   # the reference's form (fused.grant_form)
    occupancy_peak: int = 0     # max live request rows over the lanes
    compact_capacity: int = 0   # compact step's final ladder rung (0=dense)
    superstep: int = 1          # K, the cycles a superstep advances
    escalations: int = 0        # capacity-ladder reruns this run needed
    # captures (CPU, eager loop: step functions) the ABANDONED runs
    # cost, kept out of `compile_count`: each ladder rung is its own step
    escalation_compiles: int = 0
    loop: str = "graph"         # the cycle loop that ran ("eager" for the
                                # channel-sharded step, see the docstring)


@dataclass
class SweepResult:
    """SimResults on the (rate x seed) grid, plus curve-level reductions.

    For fault sweeps (`BatchedSweep.run_faults`) the row axis is the fault
    grid: `rates[i]` repeats the common offered load and `fault_fracs[i]`
    labels row i with its failed-link fraction.  `placement` and
    `pad_fraction` are the dispatch's (see the module docstring);
    `compile_count`, `compile_s`, `escalation_compiles` and `loop` are as
    in `LaneRun`.  `grant_form` is the form the reference's step would
    compile, `compact_capacity` the compact step's final rung (0 for the
    dense steps) and `escalations` the capacity-ladder reruns."""

    rates: list[float]
    seeds: list[int]
    results: list[list]        # [num_rates][num_seeds] of SimResult
    compile_count: int = 0
    wall_s: float = 0.0
    compile_s: float = 0.0
    fault_fracs: list | None = None
    placement: str = "single"
    pad_fraction: float = 0.0
    grant_form: str = "two_pass"
    occupancy_peak: int = 0
    compact_capacity: int = 0
    superstep: int = 1
    escalations: int = 0
    escalation_compiles: int = 0
    loop: str = "graph"

    def result(self, rate_idx: int, seed_idx: int = 0):
        return self.results[rate_idx][seed_idx]

    def flat(self):
        return [r for row in self.results for r in row]

    def mean_over_seeds(self) -> list:
        """One seed-averaged SimResult per rate: means of rates/latencies,
        floor-averaged packet counters, and the exact per-lane MAX of the
        `stranded_pkts` gauge (with its exact mean in `stranded_mean`)
        and of `occupancy_peak`."""
        from ..simulator import SimResult
        out = []
        for row in self.results:
            n = len(row)
            hops = {k: sum(r.hops_by_type[k] for r in row) // n
                    for k in row[0].hops_by_type}
            avg_hops = {k: float(np.mean([r.avg_hops_by_type[k] for r in row]))
                        for k in row[0].avg_hops_by_type}
            out.append(SimResult(
                offered_per_chip=row[0].offered_per_chip,
                throughput_per_chip=float(
                    np.mean([r.throughput_per_chip for r in row])),
                avg_latency=float(np.mean([r.avg_latency for r in row])),
                delivered_pkts=sum(r.delivered_pkts for r in row) // n,
                generated_pkts=sum(r.generated_pkts for r in row) // n,
                dropped_pkts=sum(r.dropped_pkts for r in row) // n,
                hops_by_type=hops, avg_hops_by_type=avg_hops,
                stranded_pkts=max(r.stranded_pkts for r in row),
                stranded_mean=float(
                    np.mean([r.stranded_pkts for r in row])),
                reaped_pkts=sum(r.reaped_pkts for r in row) // n,
                occupancy_peak=max(r.occupancy_peak for r in row)))
        return out

    def saturation_throughput(self) -> float:
        """Max seed-averaged accepted throughput over the sweep."""
        return max(r.throughput_per_chip for r in self.mean_over_seeds())


class _Chunk:
    """One device's share of a dispatch: the padded lanes ``[lo, hi)`` on
    `device` (physical), with the step, state, rates and lane data there.
    A channel-sharded chunk (a lane row) holds one of each a shard
    instead, and its `step` is the `fused.ShardedStep`."""

    __slots__ = ("device", "lo", "hi", "step", "state", "rates", "lanes")

    def __init__(self, device, lo, hi, step, state, rates, lanes):
        self.device, self.lo, self.hi = device, lo, hi
        self.step, self.state = step, state
        self.rates, self.lanes = rates, lanes


class _LanePlan:
    """A prepared — and on the graph loop captured — lane dispatch that
    has not run yet (`BatchedSweep.warm_compile`); single-use."""

    def __init__(self, lanes, fault_sets, keys, chunks, step, K, form,
                 compile_s, compile_count, grant_form, placement,
                 pad_fraction, device, shards):
        self.lanes, self.fault_sets = lanes, fault_sets
        self.keys = keys          # [Bp, 2] on the CPU, ghosts included
        self.chunks = chunks      # list of _Chunk, in lane order
        self.step, self.K, self.form = step, K, form
        self.compile_s, self.compile_count = compile_s, compile_count
        self.grant_form = grant_form
        self.placement, self.pad_fraction = placement, pad_fraction
        self.device = device      # the pinned device, or None
        self.shards = shards      # channel shards a lane row (1: none)
        self.capacity = getattr(step, "compact_capacity", 0)
        self.rows = getattr(step, "compact_rows", 0)
        self.used = False


class _PendingLanes:
    """An issued `run_lanes_async` call: every chunk's cycle loop has been
    issued (a CUDA device runs it asynchronously); `finish()` waits for
    the counters, builds the per-lane `SimResult`s, and escalates a
    compact run whose live set outgrew its rung."""

    def __init__(self, sweep, stats, plan, t0, run_capture_s):
        self._sweep, self._stats, self._plan = sweep, stats, plan
        self._t0, self._run_capture_s = t0, run_capture_s

    def finish(self) -> LaneRun:
        stats = _host_stats(self._stats)
        wall = time.perf_counter() - self._t0 - self._run_capture_s
        sweep, cfg, plan = self._sweep, self._sweep.cfg, self._plan
        B = len(plan.lanes)
        occ = int(stats.occ_peak[:B].max())
        if plan.capacity and occ > plan.capacity:
            # capacity breach: every cycle after the crossing arbitrated
            # over a TRUNCATED active set, so nothing of this run is kept.
            # Re-run the whole grid at the next rung with the same
            # placement; the rerun is deterministic, so its result is the
            # oracle's.  `occ` is exact and the top rung C = N cannot
            # breach.
            rung = next_rung(plan.rows, occ)
            sweep._capacity_floor = max(sweep._capacity_floor, rung)
            redo = sweep.run_lanes_async(plan.lanes, device=plan.device,
                                         capacity=rung).finish()
            return redo._replace(
                wall_s=redo.wall_s + wall,
                compile_s=redo.compile_s + plan.compile_s,
                escalations=redo.escalations + 1,
                escalation_compiles=(redo.escalation_compiles
                                     + plan.compile_count))
        results = [finalize(lane_stats(stats, i), cfg, plan.lanes[i][0],
                            sweep._chips(plan.fault_sets[i]))
                   for i in range(B)]         # ghost lanes excluded
        return LaneRun(results, wall, plan.compile_s, plan.compile_count,
                       plan.fault_sets, plan.placement, plan.pad_fraction,
                       plan.grant_form, occ, plan.capacity, plan.K,
                       loop="eager" if plan.shards > 1 else sweep.loop)


def _host(v: torch.Tensor) -> np.ndarray:
    """A host copy of `v` (never a view of a CPU tensor that the session
    goes on advancing)."""
    return v.detach().to("cpu", copy=True).numpy()


def _host_stats(parts: list) -> SimStats:
    """The counters of a dispatch's chunks, in lane order, on the CPU
    (waits for each chunk)."""
    return SimStats(**{k: torch.cat([getattr(p, k).cpu() for p in parts])
                       for k in vars(parts[0])})


def _host_state(state: SimState) -> SimState:
    """A `SimState` of host numpy arrays (`b_pkt` without its sink row)."""
    return SimState(stats=SimStats(**{k: _host(v) for k, v
                                      in vars(state.stats).items()}),
                    **{k: _host(v) for k, v in vars(state).items()
                       if k != "stats"})


def _host_states(states: list) -> SimState:
    """`_host_state` of chunk states, joined on the lane axis."""
    parts = [_host_state(s) for s in states]
    join = lambda get: np.concatenate([get(p) for p in parts])
    return SimState(
        stats=SimStats(**{k: join(lambda p, k=k: getattr(p.stats, k))
                          for k in vars(parts[0].stats)}),
        **{k: join(lambda p, k=k: getattr(p, k)) for k in vars(parts[0])
           if k != "stats"})


def _snapshot_signature(state) -> tuple:
    """(field, shape, numpy dtype) of a `SimState` of tensors or arrays."""
    def sig(v):
        dt = (v.dtype if isinstance(v, np.ndarray)
              else torch.empty(0, dtype=v.dtype).numpy().dtype)
        return tuple(v.shape), str(dt)
    out = [(k, sig(v)) for k, v in vars(state).items() if k != "stats"]
    out += [(f"stats.{k}", sig(v)) for k, v in vars(state.stats).items()]
    return tuple(out)


def _load_state(state: SimState, host: SimState, lo: int = 0) -> None:
    """Copy the lanes ``[lo, lo + B)`` of a host snapshot into the device
    buffers of `state` (B lanes)."""
    B = state.b_head.shape[0]
    put = lambda dst, src: dst.copy_(torch.as_tensor(
        np.asarray(src)[lo:lo + B]))
    for k, v in vars(state).items():
        if k != "stats":
            put(v, getattr(host, k))
    for k, v in vars(state.stats).items():
        put(v, getattr(host.stats, k))


def _lanes_on(lane_data: dict, lo: int, hi: int,
              device: torch.device) -> dict:
    """Lanes ``[lo, hi)`` of `lane_data` on physical `device` (views where
    they are already there; a shared lane stays a stride-0 view)."""
    return {k: to_device(v[lo:hi], device) for k, v in lane_data.items()}


def _pad_lanes(rates, keys, lane_data, pad: int):
    """Ghost lanes: `pad` more lanes at offered rate 0 (inject generates
    nothing) with lane 0's key and fault data (a shared lane dict stays
    shared); their counters are never read back."""
    if not pad:
        return rates, keys, lane_data
    Bp = rates.shape[0] + pad
    rates = torch.cat([rates, rates.new_zeros(pad)])
    keys = torch.cat([keys, keys[:1].expand(pad, 2)])
    grow = lambda v, n: v[:1].expand((n,) + tuple(v.shape[1:]))
    lane_data = {k: grow(v, Bp) if v.stride(0) == 0
                 else torch.cat([v, grow(v, pad)])
                 for k, v in lane_data.items()}
    return rates, keys, lane_data


class LaneSession:
    """A paused, resumable lane dispatch advanced window by window
    (`BatchedSweep.start_lanes`).

    The session holds its chunks' `SimState`s on their devices (one chunk
    unless its lanes are spread), the lanes' keys (``[Bp, 2]`` int64 words
    on the CPU, where the chain is drawn) and the absolute cycle between
    windows.  `advance` runs one window's real cycles (see the module
    docstring) on every chunk; chained windows replay the one-shot key
    chain, so `finish()` equals `run_lanes` on the same lane triples.
    `export()` snapshots the dynamic state to host numpy arrays, the
    chunks joined; `start_lanes(..., restore=snapshot)` resumes from it
    bit for bit, since the state, the keys and the cycle are the whole of
    it."""

    def __init__(self, sweep, lane_triples, fault_sets, window, total,
                 cycle, chunks, keys, step, superstep, placement,
                 pad_fraction, grant_form):
        self.sweep = sweep
        self.lane_triples = lane_triples
        self.fault_sets = fault_sets
        self.window, self.total, self.cycle = window, total, cycle
        self.chunks, self.keys = chunks, keys
        self.step, self.superstep = step, superstep
        self.placement = placement
        self.pad_fraction = pad_fraction
        self.grant_form = grant_form
        self.capacity = getattr(step, "compact_capacity", 0)
        self.num_lanes = len(lane_triples)
        # the graphs `start_lanes` made for the session (captures on
        # CUDA, static buffers on the CPU) and their seconds
        self.compile_s, self.compile_count = 0.0, 0

    def done(self) -> bool:
        return self.cycle >= self.total

    def advance(self) -> int:
        """Run one window (`window` cycles, clipped at the budget) on
        every chunk, each issued before any is read; returns the new
        absolute cycle."""
        if self.done():
            return self.cycle
        real = min(self.window, self.total - self.cycle)
        keys, subs = _key_chain_seq(self.keys, real)
        reset_at = self.sweep.cfg.warmup
        for ch in self.chunks:
            with _on(ch.device):
                self._advance_chunk(ch, subs[:, ch.lo:ch.hi].to(ch.device),
                                    real, reset_at)
        self.keys = keys[real]
        self.cycle += real
        return self.cycle

    def _advance_chunk(self, ch, subs, real, reset_at) -> None:
        if self.sweep.loop == "eager":
            ch.state = run_steps(ch.step, self.cycle, subs, reset_at,
                                 ch.state, ch.rates, ch.lanes)
            return
        main = real - real % self.superstep
        t = self.cycle
        for k, n in ((self.superstep, main), (1, real - main)):
            if n:
                graph, _ = graphs.graph_for(ch.step, k, ch.state, ch.rates,
                                            ch.lanes)
                graph.advance(ch.state, ch.rates, ch.lanes, reset_at,
                              subs[t - self.cycle:t - self.cycle + n], t)
                t += n

    def stats_host(self) -> SimStats:
        """The per-lane counters as host numpy arrays (leading axis the
        padded lane count; the real lanes come first)."""
        return SimStats(**{k: np.concatenate(
            [_host(getattr(ch.state.stats, k)) for ch in self.chunks])
            for k in vars(self.chunks[0].state.stats)})

    def lane_stats(self, i: int) -> SimStats:
        """Real lane i's current counters (host)."""
        return lane_stats(self.stats_host(), i)

    def export(self) -> dict:
        """The session's dynamic state as host arrays: ``{"state":
        SimState of numpy, "keys": [Bp, 2] int64, "cycle": int}``."""
        return dict(state=_host_states([ch.state for ch in self.chunks]),
                    keys=self.keys.numpy().copy(), cycle=int(self.cycle))

    def finish(self) -> LaneRun:
        """Per-lane `SimResult`s once the budget is spent (`wall_s` is not
        tracked per window and reads 0.0)."""
        if not self.done():
            raise ValueError(
                f"session at cycle {self.cycle}/{self.total}: advance() "
                f"to the full budget before finish()")
        stats = SimStats(**{k: torch.as_tensor(v)
                            for k, v in vars(self.stats_host()).items()})
        occ = int(stats.occ_peak[:self.num_lanes].max())
        if self.capacity and occ > self.capacity:
            # a session cannot escalate: its snapshots and streamed stats
            # already hold the truncated active set
            raise RuntimeError(
                f"compact capacity {self.capacity} overflowed: the live "
                f"set peaked at {occ} rows — windowed sessions cannot "
                f"re-dispatch at a larger ladder rung mid-run; rerun "
                f"with REPRO_COMPACT_CAP>={occ} (or step_impl='fused')")
        cfg, sweep = self.sweep.cfg, self.sweep
        results = [finalize(lane_stats(stats, i), cfg,
                            self.lane_triples[i][0],
                            sweep._chips(self.fault_sets[i]))
                   for i in range(self.num_lanes)]
        return LaneRun(results, 0.0, self.compile_s, self.compile_count,
                       self.fault_sets, self.placement, self.pad_fraction,
                       self.grant_form, occ, self.capacity, self.superstep,
                       loop=sweep.loop)


class BatchedSweep:
    """Sweep runner over an arbitrary lane grid: one step serves every
    (rate, seed, fault) lane.  `faults` degrades every lane with one fault
    state; `run_faults` runs a grid of different fault states together.
    `loop` names the cycle loop (`LOOPS`, default "graph"): the eager one
    is the parity yardstick and runs only when named.  `device` is the
    sweep's own device; a run may spread over `host_devices(device)` or
    be pinned to one of them (see the module docstring).  Its steps live
    in one cache keyed by (physical devices, channel shards, compact rung),
    seeded with its own `step` on its own device; `lane0` is built on the
    sweep's device and a chunk elsewhere takes its rows through
    `to_device`."""

    def __init__(self, net: Network, cfg, pattern, inject_mask=None,
                 step=None, consts=None, faults: FaultSet | None = None,
                 lane=None, *, device=None, loop: str | None = None):
        self.net, self.cfg = net, cfg
        self.device = resolve_device(device)
        self.loop = "graph" if loop is None else loop
        if self.loop not in LOOPS:
            raise ValueError(f"unknown loop {self.loop!r}; valid: {LOOPS}")
        pattern = as_pattern(pattern, inject_mask)
        if step is None:
            step, consts = make_step(net, cfg, pattern, device=self.device)
        compact = getattr(cfg, "step_impl", "jnp") == "compact"
        # the rung the sweep's own step was built at (0: not compact)
        self._rung0 = (getattr(step, "compact_capacity", 0) or 0
                       if compact else 0)
        self._base = ((physical_device(self.device),), 1, self._rung0)
        self._steps: dict = {}      # (physical devices, shards, rung)
        self.step, self.consts = step, consts
        self.NV = consts["NV"]
        self._pattern = pattern
        self._capacity_floor = 0    # highest escalated rung seen so far
        self.faults = faults
        self.lane0 = (build_lane(net, cfg, faults, device=self.device)
                      if lane is None else lane)
        self.terms_per_chip = net.num_terminals / net.num_chips
        self._inj_mask = (np.ones(net.num_terminals, dtype=bool)
                          if pattern.inject_mask is None
                          else np.asarray(pattern.inject_mask).astype(bool))

    def _rate_pkt(self, offered_per_chip: float) -> float:
        return offered_to_rate_pkt(offered_per_chip, self.cfg,
                                   self.terms_per_chip)

    @property
    def step(self):
        """The sweep's own step: on its device, at its first rung."""
        return self._steps[self._base]

    @step.setter
    def step(self, step) -> None:
        self._steps[self._base] = step

    def _step_for(self, row: list, shards: int = 1, capacity=None):
        """The dispatch's step on lane row `row` (logical devices, one a
        channel shard): the K-way channel-sharded fused step when
        `shards` > 1, else, on ``row[0]``, the compact step at `capacity`
        (without it, at the rung this sweep escalated to, else its first)
        or the base step.  Built once for each (physical devices, shards,
        rung)."""
        compact = getattr(self.cfg, "step_impl", "jnp") == "compact"
        C = ((int(capacity) if capacity is not None
              else self._capacity_floor or self._rung0)
             if compact and shards == 1 else 0)
        key = (tuple(physical_device(d) for d in row), shards, C)
        step = self._steps.get(key)
        if step is None:
            step = self._steps[key] = self._build_step(row, shards, C)
        return step

    def _build_step(self, row: list, shards: int, C: int):
        if shards > 1:
            return make_fused_step(self.net, self.cfg, self._pattern,
                                   shards=shards, devices=row)[0]
        dev = physical_device(row[0])
        if C:
            return make_compact_step(self.net, self.cfg, self._pattern,
                                     capacity=C, device=dev)[0]
        return make_step(self.net, self.cfg, self._pattern, device=dev)[0]

    def _chips(self, faults) -> float:
        """Accepted-throughput divisor: chips weighted by the fraction of
        terminals that inject (mask AND alive); a schedule reports its
        FINAL epoch."""
        faults = final_faults(faults)
        alive = (self._inj_mask if faults is None
                 else self._inj_mask & faults.term_alive(self.net))
        return self.net.num_chips * alive.sum() / self.net.num_terminals

    def _prepare_lanes(self, lanes, force_stack: bool = False,
                       epochs: int | None = None):
        """Compose per-lane fault data; returns the lane rates ``[B]``,
        keys ``[B, 2]`` (on the CPU), the lane-stacked fault dict and the
        composed fault states.  When any lane is warm (a `FaultSchedule`)
        every lane is promoted to a schedule so all lanes share one
        epoch-stacked structure; when every lane has one fault state it is
        shared (stride-0 views) instead of stacked.  `force_stack` stacks
        even then, and `epochs` forces the schedule form padded to at
        least that many epochs, so a window session's signature never
        depends on which lanes were packed together."""
        cfg = self.cfg
        lanes = list(lanes)
        if not lanes:
            raise ValueError("run_lanes needs >= 1 lane")
        base = self.faults
        fsets = [compose_faults(base, f) for _, _, f in lanes]
        if (epochs is not None
                or any(isinstance(f, FaultSchedule) for f in fsets)):
            fsets = [as_fault_schedule(f) for f in fsets]
        rates = torch.tensor([self._rate_pkt(r) for r, _, _ in lanes],
                             dtype=torch.float32, device=self.device)
        keys = torch.stack([jr.PRNGKey(int(s)) for _, s, _ in lanes])
        B = len(lanes)
        if len(set(fsets)) == 1 and not force_stack:
            fl = (self.lane0 if fsets[0] == base
                  else build_lane(self.net, cfg, fsets[0],
                                  device=self.device))
            lane_data = share_lanes(fl, B)
        else:
            # FaultSet is frozen/hashable: build each distinct lane once
            memo = {}
            for f in fsets:
                if f not in memo:
                    memo[f] = build_lane(self.net, cfg, f,
                                         device=self.device)
            lane_data = stack_lanes([memo[f] for f in fsets], epochs=epochs)
        return lanes, rates, keys, lane_data, fsets

    def _placement(self, B: int, cycles: int, device, fused: bool):
        """The reference's placement rule for a dispatch of B lanes:
        (lane rows, channel shards).  Rows are lists of (logical) devices,
        one a channel shard; one row of one device when nothing spreads.
        A pinned `device` never spreads; REPRO_CHANNEL_SHARDS=K takes
        fused dispatches onto rows of K when there are at least K
        devices; otherwise lanes spread over every device from
        `shard_min_work` lane-cycles on."""
        if device is not None:
            return [[torch.device(device)]], 1
        nd = len(host_devices(self.device))
        K = channel_shards() if fused else 1
        if K > 1 and nd >= K:
            return lane_mesh(K, self.device), K
        if nd > 1 and B > 1 and B * cycles >= shard_min_work():
            return lane_mesh(1, self.device), 1
        return [[self.device]], 1

    def _plan(self, lanes, device=None, capacity=None) -> _LanePlan:
        """Prepare one dispatch, place it (`_placement`) and, on the graph
        loop, capture each chunk's graph (a cache hit captures nothing).
        `capacity` pins the compact step's ladder rung (the escalation
        rerun re-enters here with the next rung up); without it a sweep
        that escalated before starts at that rung."""
        lanes, rates, keys, lane_data, fsets = self._prepare_lanes(lanes)
        cfg = self.cfg
        B = len(lanes)
        cycles = cfg.warmup + cfg.measure
        impl = getattr(cfg, "step_impl", "jnp")
        rows, shards = self._placement(B, cycles, device, impl == "fused")
        L = len(rows)
        pad = (-B) % L
        ch_pad = fused_pad(self.net, shards)[0] if shards > 1 else 0
        E = self.net.num_channels
        pad_fraction = 1.0 - (B * E) / ((B + pad) * (E + ch_pad))
        placement = ("single" if device is not None or len(rows[0]) * L == 1
                     else f"lanes:{L},shards:{shards}" if shards > 1
                     else f"lanes:{L}")
        rates, keys, lane_data = _pad_lanes(rates, keys, lane_data, pad)
        c = (B + pad) // L
        gform = (grant_form(self.net, cfg, shards)
                 if impl in ("fused", "compact") else "two_pass")
        K = (1 if self.loop == "eager" or shards > 1
             else superstep(cycles))
        compile_s, compiles, chunks = 0.0, 1, []
        for j, row in enumerate(rows):
            lo, hi = j * c, (j + 1) * c
            step = self._step_for(row, shards, capacity)
            if shards > 1:
                lane_j = {k: v[lo:hi] for k, v in lane_data.items()}
                chunks.append(_Chunk(
                    step.physical[0], lo, hi, step,
                    step.make_states((c,)), step.place(rates[lo:hi]),
                    step.place(lane_j)))
                continue
            dev = physical_device(row[0])
            chunks.append(_Chunk(
                dev, lo, hi, step,
                make_state(self.net, cfg, self.NV, batch=(c,), device=dev),
                rates[lo:hi].to(dev), _lanes_on(lane_data, lo, hi, dev)))
        step = chunks[0].step
        form = lane_form(step, chunks[0].device) if shards == 1 else \
            "lockstep"
        if self.loop == "graph" and shards == 1 and any(
                ch.device.type == "cuda" for ch in chunks):
            compiles = 0
            for ch in chunks:
                st0, r, _, fl = (
                    (ch.state, ch.rates, None, ch.lanes)
                    if form == "lockstep"
                    else _lane_args(0, ch.state, ch.rates, keys, ch.lanes))
                with _on(ch.device):
                    graph, captured = graphs.graph_for(ch.step, K, st0, r,
                                                       fl)
                if captured:
                    compile_s += graph.capture_s
                    compiles += 1
        return _LanePlan(lanes, fsets, keys, chunks, step, K, form,
                         compile_s, compiles, gform, placement,
                         pad_fraction, device, shards)

    def warm_compile(self, lanes, device=None) -> _LanePlan:
        """Prepare the lane grid, placed on `device` or spread (see
        `_plan`), and capture its graphs without running it (nothing to
        capture on the CPU or the eager loop); hand the plan to
        `run_lanes_async(plan=...)`."""
        return self._plan(lanes, device=device)

    def start_lanes(self, lanes, *, window: int, device=None,
                    pad_to: int | None = None, force_stack: bool = False,
                    epochs: int | None = None,
                    restore: dict | None = None) -> "LaneSession":
        """Open a windowed `LaneSession` over `lanes` instead of running
        the whole cycle budget at once.

        `window` is the cycles a window advances (the last one only the
        cycles left).  `device` pins the session to one device; with None
        its lanes spread as a dispatch's do (`_placement`, channel shards
        ignored, as the reference's sessions ignore them).  `pad_to`
        ghost-pads the lane axis to a fixed batch (rate-0 lanes, dropped
        from the results) so packs of one signature share one graph;
        `force_stack` keeps the fault axis stacked and `epochs` pins the
        schedule form padded to that many epochs, for the same reason.
        `restore` resumes from an earlier session's `export()` (same
        lanes, padding, placement and config), bit for bit.  The session's
        graphs are made here: K = `superstep(window)` and, when some
        window's length is not a multiple of K, a K = 1 graph for its
        tail."""
        if window < 1:
            raise ValueError(f"window must be >= 1 cycles, got {window}")
        lanes, rates, keys, lane_data, fsets = self._prepare_lanes(
            lanes, force_stack=force_stack, epochs=epochs)
        cfg = self.cfg
        B = len(lanes)
        if pad_to is not None and pad_to < B:
            raise ValueError(f"pad_to={pad_to} < {B} lanes")
        target = max(B, pad_to or 0)
        total = cfg.warmup + cfg.measure
        rows, _ = self._placement(target, total, device, False)
        L = len(rows)
        Bp = target + (-target) % L
        rates, keys, lane_data = _pad_lanes(rates, keys, lane_data, Bp - B)
        placement = "single" if L == 1 else f"lanes:{L}"
        impl = getattr(cfg, "step_impl", "jnp")
        gform = (grant_form(self.net, cfg) if impl in ("fused", "compact")
                 else "two_pass")
        cycle = 0
        if restore is not None:
            want = make_state(self.net, cfg, self.NV, batch=(Bp,),
                              device="meta")
            if (_snapshot_signature(restore["state"]) !=
                    _snapshot_signature(want)
                    or tuple(np.shape(restore["keys"])) != tuple(keys.shape)):
                raise ValueError(
                    "restore snapshot does not match this session's lane "
                    "signature (different lane count, padding, or config)")
            cycle = int(restore["cycle"])
            if not 0 <= cycle <= total:
                raise ValueError(
                    f"restore cycle {cycle} outside [0, {total}]")
            keys = torch.as_tensor(np.asarray(restore["keys"]),
                                   dtype=torch.int64)
        c = Bp // L
        chunks = []
        for j, row in enumerate(rows):
            dev = physical_device(row[0])
            # a session cannot escalate mid-run (`finish` raises on a
            # breach), so it starts at the highest rung this sweep has
            # had to escalate to
            step = self._step_for(row)
            state = make_state(self.net, cfg, self.NV, batch=(c,),
                               device=dev)
            if restore is not None:
                _load_state(state, restore["state"], j * c)
            chunks.append(_Chunk(dev, j * c, (j + 1) * c, step, state,
                                 rates[j * c:(j + 1) * c].to(dev),
                                 _lanes_on(lane_data, j * c, (j + 1) * c,
                                           dev)))
        K = 1 if self.loop == "eager" else superstep(window)
        session = LaneSession(self, lanes, fsets, window, total, cycle,
                              chunks, keys, chunks[0].step, K, placement,
                              1.0 - B / Bp, gform)
        if self.loop == "graph":
            # every window but the last is `window` cycles, a multiple of K
            before, t0 = graphs.builds(), time.perf_counter()
            tail = (total - cycle) % window % K
            for ch in chunks:
                with _on(ch.device):
                    for k in ((K, 1) if K > 1 and tail else (K,)):
                        graphs.graph_for(ch.step, k, ch.state, ch.rates,
                                         ch.lanes)
            session.compile_count = graphs.builds() - before
            session.compile_s = (time.perf_counter() - t0
                                 if session.compile_count else 0.0)
        return session

    def run_lanes_async(self, lanes=None, device=None, capacity=None,
                        plan: _LanePlan | None = None) -> _PendingLanes:
        """Issue the lane grid's cycle loop on every chunk without waiting
        for its counters (`device` and `capacity` as in `_plan`; `plan`
        runs a `warm_compile` plan instead of preparing anew)."""
        if plan is None:
            plan = self._plan(lanes, device=device, capacity=capacity)
        if plan.used:
            raise ValueError("a lane plan is single-use: warm_compile a "
                             "fresh one")
        plan.used = True
        cfg = self.cfg
        cycles = cfg.warmup + cfg.measure
        t0 = time.perf_counter()
        subs = _key_chain(plan.keys, cycles)         # on the CPU, [c, Bp, 2]
        if plan.shards > 1:
            stats, made, capture_s = _run_sharded(plan.chunks, cycles,
                                                  cfg.warmup, subs), 0, 0.0
        else:
            scan = (_scan_lanes if plan.form == "lockstep"
                    else _scan_lanes_seq)
            stats, made, capture_s = [], 0, 0.0
            for ch in plan.chunks:
                with _on(ch.device):
                    st, m, cs = scan(ch.step, cycles, cfg.warmup, plan.K,
                                     self.loop, ch.state, ch.rates, None,
                                     ch.lanes,
                                     subs=subs[:, ch.lo:ch.hi].to(ch.device))
                stats.append(st)
                made, capture_s = made + m, capture_s + cs
        plan.chunks = None
        plan.compile_count += made
        plan.compile_s += capture_s
        return _PendingLanes(self, stats, plan, t0, capture_s)

    def run_lanes(self, lanes, device=None) -> LaneRun:
        """One batched run over a list of `(offered_per_chip, seed, faults)`
        lane triples, where `faults` is a `FaultSet`, a warm
        `FaultSchedule`, or None; each composes on top of the sweep's base
        `faults`.  `device` pins the run to one device; None places it
        (see the module docstring).  Returns a `LaneRun` (one `SimResult`
        per lane, in order)."""
        return self.run_lanes_async(lanes, device=device).finish()

    def run(self, rates, seeds=None) -> SweepResult:
        cfg = self.cfg
        rates = [float(r) for r in rates]
        seeds = [cfg.seed] if seeds is None else [int(s) for s in seeds]
        R, S = len(rates), len(seeds)
        if R * S == 0:
            raise ValueError(
                f"sweep needs >= 1 rate and >= 1 seed (got {R} rates, "
                f"{S} seeds)")
        run = self.run_lanes([(r, s, None) for r in rates for s in seeds])
        flat = run.results
        results = [[flat[i * S + j] for j in range(S)] for i in range(R)]
        return SweepResult(rates=rates, seeds=seeds, results=results,
                           compile_count=run.compile_count,
                           wall_s=run.wall_s, compile_s=run.compile_s,
                           **_run_fields(run))

    def run_faults(self, offered_per_chip: float, fault_grid,
                   seeds=None) -> SweepResult:
        """Degraded-throughput grid: one lane per (fault set, seed), all at
        the same offered load.  Row i of `fault_grid` is one `FaultSet` /
        `FaultSchedule` shared by every seed, or a per-seed list; entries
        compose on top of the sweep's base faults."""
        cfg = self.cfg
        seeds = [cfg.seed] if seeds is None else [int(s) for s in seeds]
        S = len(seeds)
        rows = [list(fs) if isinstance(fs, (list, tuple)) else [fs] * S
                for fs in fault_grid]
        if not rows or any(len(r) != S for r in rows):
            raise ValueError("fault_grid rows must match the seed count")
        F = len(rows)
        run = self.run_lanes(
            [(offered_per_chip, seeds[j], rows[i][j])
             for i in range(F) for j in range(S)])
        flat, fsets = run.results, run.fault_sets
        results = [[flat[i * S + j] for j in range(S)] for i in range(F)]
        fracs = [float(np.mean(
            [0.0 if f is None
             else final_faults(f).frac_links_failed(self.net)
             for f in fsets[i * S:(i + 1) * S]])) for i in range(F)]
        return SweepResult(rates=[offered_per_chip] * F, seeds=seeds,
                           results=results, compile_count=run.compile_count,
                           wall_s=run.wall_s, compile_s=run.compile_s,
                           fault_fracs=fracs, **_run_fields(run))


def _run_sharded(chunks: list, cycles: int, reset_at: int, subs) -> list:
    """The channel-sharded dispatch's eager loop: every lane row's
    `ShardedStep` one host-int cycle at a time, the rows interleaved
    cycle by cycle (so rows on different cards run together), the warmup
    reset on every shard.  Returns each row's lead-shard counters."""
    keys = [ch.step.place(subs[:, ch.lo:ch.hi]) for ch in chunks]
    for t in range(cycles):
        for ch, k in zip(chunks, keys):
            ch.state, _ = ch.step(ch.state, (t, [x[t] for x in k],
                                             ch.rates, ch.lanes))
            if t == reset_at:
                ch.state = ch.step.reset_stats(ch.state)
    return [ch.state[0].stats for ch in chunks]


def _run_fields(run: LaneRun) -> dict:
    """The `LaneRun` telemetry a `SweepResult` carries over."""
    return dict(placement=run.placement, pad_fraction=run.pad_fraction,
                grant_form=run.grant_form,
                occupancy_peak=run.occupancy_peak,
                compact_capacity=run.compact_capacity,
                superstep=run.superstep,
                escalations=run.escalations,
                escalation_compiles=run.escalation_compiles,
                loop=run.loop)
