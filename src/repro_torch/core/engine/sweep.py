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
- "eager": one step a host-int cycle (`step.run_steps`), the parity
  yardstick, only when asked for.

K is `superstep(span)` (REPRO_SUPERSTEP, falling back to 1 when it does
not divide the span); every substep keeps its own absolute cycle and
zeroes the stats on the device at the end of warmup, so any K gives the
counters of K = 1.

One dispatch serves both forms of a run: `BatchedSweep._dispatch` makes
it, and `_advance` runs it, drawing the lanes' key chain once
(`step.key_chain`) and issuing every chunk before it reads any.  A
one-shot run (`run_lanes`) is one window of the whole budget that copies
only the counters out of its graph; a compact run whose live-row census
outgrew its rung is re-run whole at the next rung
(`_PendingLanes.finish`).  A `LaneSession` (`start_lanes`) advances
window by window and holds the state, keys and absolute cycle between
windows, so a service can stream counters, checkpoint and interleave
sessions.  A window copies the state in and out of the shared
`CycleGraph`s: the K graph for whole supersteps, a K = 1 graph for a
shorter tail.  Chained windows replay the one-shot key chain, so
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
from .step import key_chain, make_step, run_steps

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


def run_scan_batched(step, cycles: int, reset_at: int, state0, rate_pkt,
                     keys, lanes, per_lane_faults: bool) -> SimState:
    """Single-device batched scan, the reference's stable public entry
    point: the B lanes of `state0` (offered packet rates `rate_pkt` [B],
    keys [B, 2]) advance `cycles` cycles in lockstep from cycle 0, the
    stats zeroed after cycle `reset_at`; returns the final `SimState`,
    every field.  `lanes` is lane-stacked ([B, ...]) with
    `per_lane_faults`, else one lane dict shared by every lane.

    It runs one chunk through the sweep's `_advance`: `run_steps` on the
    CPU, a `CycleGraph` of one cycle on CUDA (the state copied in and
    back out).  `state0` is left as it was (the reference donates it)."""
    B = int(rate_pkt.shape[0])
    fl = lanes if per_lane_faults else share_lanes(lanes, B)
    state = graphs.state_like(state0)
    graphs.copy_state(state, state0)
    loop = "graph" if rate_pkt.device.type == "cuda" else "eager"
    return _run_pinned(step, cycles, reset_at, 1, loop, state, rate_pkt,
                       keys, fl, keep=True)


def _run_pinned(step, cycles: int, reset_at: int, K: int, loop: str, state,
                rate_pkt, keys, lanes, keep: bool = False):
    """The lanes of `state` as one chunk on their own device, advanced
    `cycles` cycles from cycle 0 by `_advance` (`Simulator.run` and
    `run_scan_batched`); returns the final state with `keep`, else the
    final counters."""
    ch = _Chunk(rate_pkt.device, 0, int(rate_pkt.shape[0]), step, state,
                rate_pkt, lanes)
    stats = _advance([ch], keys, 0, cycles, reset_at, K, loop, keep=keep)[1]
    return ch.state if keep else stats[0]


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


class _Dispatch:
    """A prepared lane dispatch (`BatchedSweep._dispatch`): the lanes
    padded and cut into chunks on their devices, their keys and absolute
    cycle, and the graphs made for them.  `warm_compile` hands one out as
    a single-use plan that `run_lanes_async` runs as one window of the
    whole budget; a `LaneSession` is one advanced window by window."""

    def __init__(self, sweep, lanes, fault_sets, keys, cycle, chunks,
                 superstep, shards, grant_form, placement, pad_fraction,
                 device, window):
        self.sweep = sweep
        self.lanes, self.fault_sets = lanes, fault_sets
        self.num_lanes = len(lanes)
        # [Bp, 2], ghosts included: on the CPU until the first window
        # moves them to the first chunk's device, where the chain is drawn
        self.keys = keys
        self.cycle = cycle        # the absolute cycle the chunks are at
        self.total = sweep.cfg.warmup + sweep.cfg.measure
        self.window = window or self.total
        self.chunks = chunks      # list of _Chunk, in lane order
        self.step, self.superstep = chunks[0].step, superstep
        self.shards = shards      # channel shards a lane row (1: none)
        self.grant_form = grant_form
        self.placement, self.pad_fraction = placement, pad_fraction
        self.device = device      # the pinned device, or None
        self.capacity = getattr(self.step, "compact_capacity", 0)
        # the graphs made ahead (see `BatchedSweep._dispatch`)
        self.compile_s, self.compile_count = 0.0, 0
        self.used = False

    def _run(self, real: int, keep: bool = True) -> tuple:
        """`_advance` the chunks `real` cycles from the dispatch's cycle;
        returns its counters, captures and capture seconds."""
        sweep = self.sweep
        self.keys, stats, made, capture_s = _advance(
            self.chunks, self.keys, self.cycle, real, sweep.cfg.warmup,
            self.superstep, sweep.loop, self.shards, keep)
        self.cycle += real
        return stats, made, capture_s

    def _lane_run(self, stats: SimStats, wall_s: float, occ: int) -> LaneRun:
        """The `LaneRun` of the final counters `stats` (host, the ghost
        lanes last and never read) that peaked at `occ` live rows."""
        sweep = self.sweep
        results = [finalize(lane_stats(stats, i), sweep.cfg,
                            self.lanes[i][0], sweep._chips(self.fault_sets[i]))
                   for i in range(self.num_lanes)]
        return LaneRun(results, wall_s, self.compile_s, self.compile_count,
                       self.fault_sets, self.placement, self.pad_fraction,
                       self.grant_form, occ, self.capacity, self.superstep,
                       loop="eager" if self.shards > 1 else sweep.loop)


def _advance(chunks: list, keys, t: int, real: int, reset_at: int, K: int,
             loop: str, shards: int = 1, keep: bool = True) -> tuple:
    """Advance a dispatch's chunks `real` cycles from absolute cycle `t`
    (`keys` ``[Bp, 2]`` the lanes' keys there): one key chain for every
    chunk, drawn on the first chunk's device (the keys move there once,
    at a dispatch's first window), each chunk issued before any is read.
    Lane rows of channel shards run `_run_sharded`; a chunk runs
    `run_steps` on the eager loop, else its K graph and a K = 1 graph for
    a tail.  `keep` (a window)
    copies each graph's state back out; without it (a one-shot run) only
    the counters leave.  Returns (the keys after `real` cycles, each
    chunk's counters, graphs captured here, their capture seconds)."""
    keys, subs = key_chain(keys.to(chunks[0].device), real)
    if shards > 1:
        return keys, _run_sharded(chunks, t, reset_at, subs), 0, 0.0
    stats, made, capture_s = [], 0, 0.0
    main = real - real % K
    for ch in chunks:
        sub = subs[:, ch.lo:ch.hi].to(ch.device)
        out = None
        with _on(ch.device):
            if loop == "eager":
                ch.state = run_steps(ch.step, t, sub, reset_at, ch.state,
                                     ch.rates, ch.lanes)
                stats.append(ch.state.stats)
                continue
            for k, lo, hi in ((K, 0, main), (1, main, real)):
                if lo == hi:
                    continue
                graph, captured = graphs.graph_for(ch.step, k, ch.state,
                                                   ch.rates, ch.lanes)
                if captured:
                    made, capture_s = made + 1, capture_s + graph.capture_s
                args = (ch.state, ch.rates, ch.lanes, reset_at, sub[lo:hi],
                        t + lo)
                if keep or hi < real:
                    graph.advance(*args)
                else:
                    out = graph.run(*args)
        stats.append(ch.state.stats if out is None else out)
    return keys, stats, made, capture_s


class _PendingLanes:
    """An issued `run_lanes_async` call: every chunk's cycle loop has been
    issued (a CUDA device runs it asynchronously); `finish()` waits for
    the counters, builds the per-lane `SimResult`s, and escalates a
    compact run whose live set outgrew its rung."""

    def __init__(self, stats, plan, t0, run_capture_s):
        self._stats, self._plan = stats, plan
        self._t0, self._run_capture_s = t0, run_capture_s

    def finish(self) -> LaneRun:
        stats = _host_stats(self._stats)
        wall = time.perf_counter() - self._t0 - self._run_capture_s
        sweep, plan = self._plan.sweep, self._plan
        occ = int(stats.occ_peak[:plan.num_lanes].max())
        if plan.capacity and occ > plan.capacity:
            # capacity breach: every cycle after the crossing arbitrated
            # over a TRUNCATED active set, so nothing of this run is kept.
            # Re-run the whole grid at the next rung with the same
            # placement; the rerun is deterministic, so its result is the
            # oracle's.  `occ` is exact and the top rung C = N cannot
            # breach.
            rung = next_rung(plan.step.compact_rows, occ)
            sweep._capacity_floor = max(sweep._capacity_floor, rung)
            redo = sweep.run_lanes_async(plan.lanes, device=plan.device,
                                         capacity=rung).finish()
            return redo._replace(
                wall_s=redo.wall_s + wall,
                compile_s=redo.compile_s + plan.compile_s,
                escalations=redo.escalations + 1,
                escalation_compiles=(redo.escalation_compiles
                                     + plan.compile_count))
        return plan._lane_run(stats, wall, occ)


def _host_stats(parts: list) -> SimStats:
    """The counters of a dispatch's chunks, in lane order, on the CPU
    (waits for each chunk)."""
    return SimStats(**{k: torch.cat([getattr(p, k).cpu() for p in parts])
                       for k in vars(parts[0])})


def _host_states(states: list) -> SimState:
    """Chunk states as one `SimState` of host numpy arrays, joined on the
    lane axis (`b_pkt` without its sink row)."""
    # host copies: never views of CPU tensors the session goes on advancing
    join = lambda get: np.concatenate(
        [get(s).detach().to("cpu", copy=True).numpy() for s in states])
    return SimState(
        stats=SimStats(**{k: join(lambda s, k=k: getattr(s.stats, k))
                          for k in vars(states[0].stats)}),
        **{k: join(lambda s, k=k: getattr(s, k)) for k in vars(states[0])
           if k != "stats"})


def _snapshot_signature(state) -> tuple:
    """(field, shape, numpy dtype) of a `SimState` of tensors or arrays."""
    def sig(v):
        dt = (v.dtype if isinstance(v, np.ndarray)
              else torch.empty(0, dtype=v.dtype).numpy().dtype)
        return tuple(v.shape), str(dt)
    return tuple((k, sig(v)) for k, v in graphs._leaves(state).items())


def _load_state(state: SimState, host: SimState, lo: int = 0) -> None:
    """Copy the lanes ``[lo, lo + B)`` of a host snapshot into the device
    buffers of `state` (B lanes)."""
    B = state.b_head.shape[0]
    src = graphs._leaves(host)
    for k, v in graphs._leaves(state).items():
        v.copy_(torch.as_tensor(np.asarray(src[k])[lo:lo + B]))


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


class LaneSession(_Dispatch):
    """A paused, resumable lane dispatch advanced window by window
    (`BatchedSweep.start_lanes`).

    The session holds its chunks' `SimState`s on their devices (one chunk
    unless its lanes are spread), the lanes' keys (``[Bp, 2]`` int64 words
    on the first chunk's device, where the chain is drawn, from the first
    window on) and the absolute cycle between windows.  `advance` runs
    one window's real cycles (see the module docstring) on every chunk;
    chained windows replay the one-shot key chain, so `finish()` equals
    `run_lanes` on the same lane triples.
    `export()` snapshots the dynamic state to host numpy arrays, the
    chunks joined; `start_lanes(..., restore=snapshot)` resumes from it
    bit for bit, since the state, the keys and the cycle are the whole of
    it.  `compile_count` and `compile_s` are the graphs `start_lanes`
    made for it (captures on CUDA, static buffers on the CPU) and their
    seconds."""

    def done(self) -> bool:
        return self.cycle >= self.total

    def advance(self) -> int:
        """Run one window (`window` cycles, clipped at the budget) on
        every chunk, each issued before any is read; returns the new
        absolute cycle."""
        if not self.done():
            self._run(min(self.window, self.total - self.cycle))
        return self.cycle

    def stats_host(self) -> SimStats:
        """The per-lane counters as host numpy arrays (leading axis the
        padded lane count; the real lanes come first)."""
        stats = _host_stats([ch.state.stats for ch in self.chunks])
        return SimStats(**{k: v.numpy() for k, v in vars(stats).items()})

    def lane_stats(self, i: int) -> SimStats:
        """Real lane i's current counters (host)."""
        return lane_stats(self.stats_host(), i)

    def export(self) -> dict:
        """The session's dynamic state as host arrays: ``{"state":
        SimState of numpy, "keys": [Bp, 2] int64, "cycle": int}``."""
        return dict(state=_host_states([ch.state for ch in self.chunks]),
                    keys=self.keys.cpu().numpy().copy(),
                    cycle=int(self.cycle))

    def finish(self) -> LaneRun:
        """Per-lane `SimResult`s once the budget is spent (`wall_s` is not
        tracked per window and reads 0.0)."""
        if not self.done():
            raise ValueError(
                f"session at cycle {self.cycle}/{self.total}: advance() "
                f"to the full budget before finish()")
        stats = _host_stats([ch.state.stats for ch in self.chunks])
        occ = int(stats.occ_peak[:self.num_lanes].max())
        if self.capacity and occ > self.capacity:
            # a session cannot escalate: its snapshots and streamed stats
            # already hold the truncated active set
            raise RuntimeError(
                f"compact capacity {self.capacity} overflowed: the live "
                f"set peaked at {occ} rows — windowed sessions cannot "
                f"re-dispatch at a larger ladder rung mid-run; rerun "
                f"with REPRO_COMPACT_CAP>={occ} (or step_impl='fused')")
        return self._lane_run(stats, 0.0, occ)


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

    def _dispatch(self, lanes, *, device=None, capacity=None, window=None,
                  pad_to=None, force_stack=False, epochs=None,
                  restore=None) -> _Dispatch:
        """One dispatch of `lanes`: prepared (`_prepare_lanes`), placed
        (`_placement`), ghost-padded to a multiple of the lane rows, cut
        into one chunk a row and, on the graph loop, each chunk's graphs
        made.  `capacity` pins the compact step's ladder rung (without
        it: the rung this sweep escalated to).  With no `window` it is a
        one-shot run (channel shards honoured; `compile_count` the
        captures, 1 on the CPU and the eager loop); with one it is a
        `LaneSession` (the other arguments are `start_lanes`'), whose
        `compile_count` is every graph made, on any device."""
        lanes, rates, keys, lane_data, fsets = self._prepare_lanes(
            lanes, force_stack=force_stack, epochs=epochs)
        cfg = self.cfg
        B = len(lanes)
        if pad_to is not None and pad_to < B:
            raise ValueError(f"pad_to={pad_to} < {B} lanes")
        target = max(B, pad_to or 0)
        total = cfg.warmup + cfg.measure
        impl = getattr(cfg, "step_impl", "jnp")
        rows, shards = self._placement(target, total, device,
                                       impl == "fused" and window is None)
        L = len(rows)
        Bp = target + (-target) % L
        ch_pad = fused_pad(self.net, shards)[0] if shards > 1 else 0
        E = self.net.num_channels
        pad_fraction = 1.0 - (B * E) / (Bp * (E + ch_pad))
        placement = ("single" if len(rows[0]) * L == 1
                     else f"lanes:{L},shards:{shards}" if shards > 1
                     else f"lanes:{L}")
        rates, keys, lane_data = _pad_lanes(rates, keys, lane_data, Bp - B)
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
            state = make_state(self.net, cfg, self.NV, batch=(c,),
                               device=dev)
            if restore is not None:
                _load_state(state, restore["state"], lo)
            # views where the lanes are already on `dev`; a shared lane
            # stays a stride-0 view
            chunks.append(_Chunk(dev, lo, hi, step, state,
                                 rates[lo:hi].to(dev),
                                 {k: to_device(v[lo:hi], dev)
                                  for k, v in lane_data.items()}))
        K = (1 if self.loop == "eager" or shards > 1
             else superstep(window or total))
        gform = (grant_form(self.net, cfg, shards)
                 if impl in ("fused", "compact") else "two_pass")
        d = (_Dispatch if window is None else LaneSession)(
            self, lanes, fsets, keys, cycle, chunks, K, shards, gform,
            placement, pad_fraction, device, window)
        d.compile_count = 0 if window else 1
        if self.loop != "graph" or shards > 1:
            return d
        # every window but the last is `window` cycles, a multiple of K
        tail = (total - cycle) % d.window % K
        builds, t0 = graphs.builds(), time.perf_counter()
        for ch in chunks:
            with _on(ch.device):
                for k in ((K, 1) if K > 1 and tail else (K,)):
                    graphs.graph_for(ch.step, k, ch.state, ch.rates,
                                     ch.lanes)
        if window or chunks[0].device.type == "cuda":
            d.compile_count = graphs.builds() - builds
            d.compile_s = (time.perf_counter() - t0 if d.compile_count
                           else 0.0)
        return d

    def warm_compile(self, lanes, device=None) -> _Dispatch:
        """Prepare the lane grid, placed on `device` or spread (see
        `_dispatch`), and capture its graphs without running it (nothing
        to capture on the CPU or the eager loop); hand the plan to
        `run_lanes_async(plan=...)`."""
        return self._dispatch(lanes, device=device)

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
        lanes, padding, placement and config), bit for bit.  The graphs
        are made here: K = `superstep(window)`, and K = 1 for a tail."""
        if window < 1:
            raise ValueError(f"window must be >= 1 cycles, got {window}")
        return self._dispatch(lanes, device=device, window=window,
                              pad_to=pad_to, force_stack=force_stack,
                              epochs=epochs, restore=restore)

    def run_lanes_async(self, lanes=None, device=None, capacity=None,
                        plan: _Dispatch | None = None) -> _PendingLanes:
        """Issue the lane grid's cycle loop on every chunk without waiting
        for its counters (`device` and `capacity` as in `_dispatch`;
        `plan` runs a `warm_compile` plan instead of preparing anew)."""
        if plan is None:
            plan = self._dispatch(lanes, device=device, capacity=capacity)
        if plan.used:
            raise ValueError("a lane plan is single-use: warm_compile a "
                             "fresh one")
        plan.used = True
        t0 = time.perf_counter()
        stats, made, capture_s = plan._run(plan.total, keep=False)
        plan.chunks = None
        plan.compile_count += made
        plan.compile_s += capture_s
        return _PendingLanes(stats, plan, t0, capture_s)

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
        return _sweep_result(run, rates, seeds)

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
        fsets = run.fault_sets
        fracs = [float(np.mean(
            [0.0 if f is None
             else final_faults(f).frac_links_failed(self.net)
             for f in fsets[i * S:(i + 1) * S]])) for i in range(F)]
        return _sweep_result(run, [offered_per_chip] * F, seeds,
                             fault_fracs=fracs)


def _run_sharded(chunks: list, t0: int, reset_at: int, subs) -> list:
    """The channel-sharded dispatch's eager loop: every lane row's
    `ShardedStep` one host-int cycle at a time from cycle `t0`, the rows
    interleaved cycle by cycle (so rows on different cards run together),
    the warmup reset on every shard.  Returns each row's lead-shard
    counters."""
    keys = [ch.step.place(subs[:, ch.lo:ch.hi]) for ch in chunks]
    for i in range(int(subs.shape[0])):
        t = t0 + i
        for ch, k in zip(chunks, keys):
            ch.state, _ = ch.step(ch.state, (t, [x[i] for x in k],
                                             ch.rates, ch.lanes))
            if t == reset_at:
                ch.state = ch.step.reset_stats(ch.state)
    return [ch.state[0].stats for ch in chunks]


def _sweep_result(run: LaneRun, rates: list, seeds: list,
                  **fields) -> SweepResult:
    """A run's lanes (row-major over `rates` x `seeds`) as a
    `SweepResult`, with the `LaneRun` telemetry it carries over."""
    S = len(seeds)
    results = [run.results[i * S:(i + 1) * S] for i in range(len(rates))]
    return SweepResult(
        rates=rates, seeds=seeds, results=results,
        compile_count=run.compile_count, wall_s=run.wall_s,
        compile_s=run.compile_s, placement=run.placement,
        pad_fraction=run.pad_fraction, grant_form=run.grant_form,
        occupancy_peak=run.occupancy_peak,
        compact_capacity=run.compact_capacity, superstep=run.superstep,
        escalations=run.escalations,
        escalation_compiles=run.escalation_compiles, loop=run.loop,
        **fields)
