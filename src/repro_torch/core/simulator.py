"""Flit-level network simulator in PyTorch (paper Sec. V) — facade.

Port of `repro.core.simulator`: `SimConfig`, `SimResult`, `Simulator`
(`run`, `sweep`, `sweep_grid`, `sweep_faults`) and
`saturation_throughput`, over the lane-batched engine in
`repro_torch.core.engine`.  Every (rate x seed x fault) lane reproduces
the reference lane bit for bit.

Device rule: a `Simulator` runs on CUDA unless it is given
``device="cpu"``; with no CUDA device and no explicit device it raises.
On CUDA the arbitration runs the hand-written kernels
(`repro_torch.kernels.netsim`: `grant` in the oracle step, `cycle_core`
in the fused and compact steps), on the CPU their plain PyTorch versions.
Every entry point runs its cycles through the sweep runner's K-cycle
supersteps (`engine.sweep`): captured CUDA graphs on CUDA, the same code
eagerly on the CPU; ``loop="eager"`` names the one-step-a-cycle loop that
both are held to.

Microarchitecture model and routing modes: see the reference module.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from .. import random as jr
from .routing import share_lanes
from .topology import FaultSchedule, FaultSet, Network, compose_faults
from .engine.arbitrate import GRANT_IMPLS
from .engine.state import build_lane, make_state, resolve_device
from .engine.step import STEP_IMPLS, make_step
from .engine.stats import finalize, lane_stats
from .engine.sweep import (BatchedSweep, SweepResult, _run_pinned,
                           offered_to_rate_pkt, superstep)


@dataclass(frozen=True)
class SimConfig:
    pkt_len: int = 4          # flits per packet (Table IV)
    buf_pkts: int = 8         # input buffer: 32 flits / 4 = 8 packets
    srcq_pkts: int = 64       # source queue depth (packets)
    vcs_per_class: int = 2    # physical VCs per deadlock class (HOL relief)
    warmup: int = 2000
    measure: int = 8000
    vc_mode: str = "baseline"          # "baseline" | "updown" | "updown_merged"
    route_mode: str = "min"            # "min" | "val" | "val_restricted" | "ugal"
    ugal_threshold: int = 3
    seed: int = 0
    # grant implementation name, validated against the reference's values
    # so configs carry over; in the port both name ONE function
    # (`kernels.netsim.ops.grant`: the CUDA kernel on the card, its plain
    # PyTorch version on the CPU)
    grant_impl: str = "jnp"
    # cycle-step implementation: "jnp" (the oracle phase pipeline),
    # "fused" or "compact" (`engine/fused.py`; bit-identical to the
    # oracle, arbitrating through `kernels.netsim.ops.cycle_core`)
    step_impl: str = "jnp"
    # router-death reaper park age (cycles); 0 disables it (see the
    # reference and `engine.state.resolve_reap_age`)
    reap_age: int = 0

    def __post_init__(self):
        if self.grant_impl not in GRANT_IMPLS:
            raise ValueError(
                f"unknown grant_impl {self.grant_impl!r}; "
                f"valid: {GRANT_IMPLS}")
        if self.step_impl not in STEP_IMPLS:
            raise ValueError(
                f"unknown step_impl {self.step_impl!r}; "
                f"valid: {STEP_IMPLS}")
        if self.reap_age < 0:
            raise ValueError(f"reap_age must be >= 0, got {self.reap_age}")

    @property
    def nonminimal(self) -> bool:
        return self.route_mode != "min"


@dataclass
class SimResult:
    offered_per_chip: float
    throughput_per_chip: float     # accepted/delivered flits per cycle per chip
    avg_latency: float             # cycles, generation -> ejection
    delivered_pkts: int
    generated_pkts: int
    dropped_pkts: int              # source-queue overflow (backlog)
    hops_by_type: dict
    avg_hops_by_type: dict = field(default_factory=dict)
    stranded_pkts: int = 0         # parked on the -1 non-channel at exit
    stranded_mean: float = 0.0     # exact mean of stranded_pkts over seeds
    reaped_pkts: int = 0           # dropped by the router-death reaper
    occupancy_peak: int = 0        # high-water mark of live request rows

    def row(self) -> str:
        return (f"{self.offered_per_chip:.3f},{self.throughput_per_chip:.3f},"
                f"{self.avg_latency:.1f}")


class Simulator:
    """One simulator per (net, cfg, pattern); sweep rates cheaply.

    ``run`` executes one offered rate (one lane); ``sweep`` and
    ``sweep_grid`` advance every (rate, seed) lane together.
    """

    def __init__(self, net: Network, cfg: SimConfig, pattern,
                 inject_mask=None,
                 faults: FaultSet | FaultSchedule | None = None,
                 device=None, loop: str | None = None):
        from .traffic import as_pattern
        self.device = resolve_device(device)
        self.net, self.cfg = net, cfg
        self.terms_per_chip = net.num_terminals / net.num_chips
        pattern = as_pattern(pattern, inject_mask)  # mask rides the pattern
        self.step, self.consts = make_step(net, cfg, pattern,
                                           device=self.device)
        self.NV = self.consts["NV"]
        self.faults = faults
        self.lane = build_lane(net, cfg, faults, device=self.device)
        self._batched = BatchedSweep(net, cfg, pattern,
                                     step=self.step, consts=self.consts,
                                     faults=faults, lane=self.lane,
                                     device=self.device, loop=loop)
        self.loop = self._batched.loop

    def run(self, offered_per_chip: float, seed: int | None = None,
            faults: FaultSet | FaultSchedule | None = None) -> SimResult:
        """One offered rate.  `faults` (a cold set or a warm schedule)
        composes on top of the instance fault state for this run only.
        Like the reference's, it runs a compact step at its starting rung
        and never escalates (only the sweeps do)."""
        cfg = self.cfg
        rate = offered_to_rate_pkt(offered_per_chip, cfg, self.terms_per_chip)
        if faults is None:
            lane, chips = self.lane, self._batched._chips(self.faults)
        else:
            faults = compose_faults(self.faults, faults)
            lane = build_lane(self.net, cfg, faults, device=self.device)
            chips = self._batched._chips(faults)
        state0 = make_state(self.net, cfg, self.NV, batch=(1,),
                            device=self.device)
        key = jr.PRNGKey(cfg.seed if seed is None else seed)[None]
        rate_pkt = torch.tensor([rate], dtype=torch.float32,
                                device=self.device)
        cycles = cfg.warmup + cfg.measure
        stats = _run_pinned(self.step, cycles, cfg.warmup,
                            superstep(cycles), self.loop, state0, rate_pkt,
                            key, share_lanes(lane, 1))
        return finalize(lane_stats(stats, 0), cfg, offered_per_chip, chips)

    def sweep(self, rates, seeds=None) -> list[SimResult]:
        """Batched load-latency curve: one (seed-averaged) `SimResult` per
        rate, in order."""
        return self.sweep_grid(rates, seeds).mean_over_seeds()

    def sweep_grid(self, rates, seeds=None) -> SweepResult:
        """Full (rate x seed) grid of `SimResult`s plus sweep metadata."""
        return self._batched.run(rates, seeds)

    def sweep_faults(self, offered_per_chip: float, fault_grid,
                     seeds=None) -> SweepResult:
        """Degraded-throughput grid: one lane per (fault set, seed) at a
        fixed offered load (see `BatchedSweep.run_faults`)."""
        return self._batched.run_faults(offered_per_chip, fault_grid, seeds)


def saturation_throughput(results: list[SimResult]) -> float:
    """Max accepted throughput over a sweep (flits/cycle/chip)."""
    return max(r.throughput_per_chip for r in results)
