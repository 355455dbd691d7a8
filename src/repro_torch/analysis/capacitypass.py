"""Capacity pass: interval analysis of the occupancy-compacted step (port
of `repro.analysis.capacitypass`, the same rules and bounds).

For every `step_impl="compact"` (topology x routing) cell the pass sizes
the capacity ladder (`fused.capacity_ladder`) against a sound worst-case
live-row bound, and audits the superstep/epoch interaction — all static,
nothing runs or captures:

  CAP_PROVED     the worst-case live-row count provably fits the
                 starting rung C0, so the runtime escalation path is
                 dead code for this cell: no rerun can ever trigger.
                 The bound is exact interval arithmetic —

                     live <= T + min(ER*NV, cycles * T)   (capped at N)

                 — at most one live source row per terminal (T), plus
                 one live buffer row per non-empty (channel, VC) buffer,
                 itself bounded by both the buffer-row count (ER*NV) and
                 the total packets a run can create (the engine enforces
                 <= 1 packet per terminal per cycle; see
                 `sweep.offered_to_rate_pkt`).
  CAP_UNPROVEN   the sound bound exceeds C0 (true for every paper-scale
                 run: buffers alone dwarf N/4).  Reported as INFO, not a
                 gate: capacity overflow is DETECTED at runtime — the
                 step folds an exact, capacity-independent live-row
                 census into `SimStats.occ_peak` every cycle and the
                 sweep layer re-dispatches the whole grid at the next
                 ladder rung on a breach (`sweep._PendingLanes.finish`,
                 one more CUDA-graph capture, which the compile pass
                 does not predict), so results stay bit-identical to
                 the oracle either way.
                 The finding carries the expected-occupancy estimate
                 (`cycles-in-flight x offered packet rate`) so a grossly
                 undersized REPRO_COMPACT_CAP pin is visible before the
                 run pays for the escalation rerun.
  CAP_EPOCH      warm-fault (epoch-scheduled) cells: proves the K-cycle
                 superstep cannot skip a fault onset.  The superstep
                 body resolves the epoch PER SUBSTEP — every cycle t in
                 [0, cycles) is enumerated with its own
                 `resolve_epoch(t)` no matter what K divides the run —
                 so an onset is applied at exactly its cycle even when
                 it lands mid-superstep.  Emitted as the proof record
                 (info) with the onset list.
  CAP_SUPERSTEP  REPRO_SUPERSTEP is set but does not divide this cell's
                 warmup+measure: `sweep.superstep` silently falls back
                 to K=1, so the requested unroll buys nothing.  A
                 warning — the env var is a deliberate operator action,
                 and the silent fallback is almost never what they
                 meant.
  CAP_PIN        REPRO_COMPACT_CAP is set but <= 0: `initial_capacity`
                 ignores it and starts at the default rung.  Warning,
                 same rationale.

Non-compact cells are skipped silently — the ladder, the census, and
the superstep epoch question only exist on the compact hot path.
"""
from __future__ import annotations

import math

from .. import env_raw
from ..core.engine.fused import (capacity_ladder, compact_rows,
                                 initial_capacity)
from ..core.engine.sweep import superstep
from ..exp.registry import get_scenario
from ..exp.spec import ExperimentSpec

PASS = "capacity"


def check_env(report) -> None:
    """One-shot audit of the compact-path env knobs (global, not
    per-scenario): values the runtime would silently ignore."""
    raw = env_raw("REPRO_COMPACT_CAP")
    if raw is not None:
        try:
            val = int(raw)
        except ValueError:
            val = 0
        if val <= 0:
            report.add(PASS, "CAP_PIN", "warning", "env:REPRO_COMPACT_CAP",
                       f"REPRO_COMPACT_CAP={raw!r} is not a positive "
                       f"integer: initial_capacity ignores it and starts "
                       f"at the default ceil(N/4) rung")


def _live_row_bound(N: int, ER: int, NV: int, T: int, cycles: int) -> int:
    """Sound worst-case live-row count (see module docstring)."""
    return min(N, T + min(ER * NV, cycles * T))


def check_spec(spec: ExperimentSpec, origin: str, report) -> None:
    """Run every capacity-pass check on one constructed spec."""
    cycles = spec.axes.warmup + spec.axes.measure
    for topo in spec.topologies:
        net = None
        for routing in spec.routings:
            if routing.step_impl != "compact":
                continue
            where = f"{origin} [{topo.label} x {routing.label}]"
            if net is None:
                net = topo.build()
            cfg = routing.to_simconfig(spec.axes)
            N = compact_rows(net, cfg)
            ER, T = net.first_eject, net.num_terminals
            NV = (N - T) // ER
            ladder = capacity_ladder(N)
            c0 = initial_capacity(N)
            bound = _live_row_bound(N, ER, NV, T, cycles)

            # expected occupancy: offered packets per cycle x the packet
            # lifetime the buffers can absorb (a sizing hint, NOT a
            # bound — the census + ladder rerun is the soundness story)
            terms_per_chip = net.num_terminals / net.num_chips
            rate_pkt = (max(spec.axes.rates) / routing.pkt_len
                        / terms_per_chip)
            est = min(N, math.ceil(rate_pkt * T) * routing.pkt_len
                      * routing.buf_pkts)

            if bound <= c0:
                report.add(
                    PASS, "CAP_PROVED", "info", where,
                    f"starting rung C0={c0} provably bounds the live "
                    f"rows: worst case {bound} = T({T}) + "
                    f"min(ER*NV={ER * NV}, cycles*T={cycles * T}) of "
                    f"N={N}; escalation is unreachable "
                    f"(ladder {ladder})")
            else:
                report.add(
                    PASS, "CAP_UNPROVEN", "info", where,
                    f"starting rung C0={c0} of N={N} is not statically "
                    f"provable (worst-case live rows {bound}); the "
                    f"runtime census (SimStats.occ_peak) + bit-identical "
                    f"ladder rerun is the checked safety net "
                    f"(ladder {ladder}, expected occupancy ~{est} at "
                    f"peak rate {max(spec.axes.rates)})")

            k = superstep(cycles)
            raw = env_raw("REPRO_SUPERSTEP")
            if raw is not None and raw.strip().isdigit() \
                    and int(raw) > 1 and k == 1:
                report.add(
                    PASS, "CAP_SUPERSTEP", "warning", where,
                    f"REPRO_SUPERSTEP={raw} does not divide "
                    f"warmup+measure={cycles}: the scan silently falls "
                    f"back to K=1 (pick a divisor of {cycles})")

            warm = [f for f in spec.axes.faults if f.onsets]
            for f in warm:
                # per-substep epoch resolution: cycle t is enumerated
                # with its own resolve_epoch(t) for ANY unroll K, so an
                # onset mid-superstep is applied at exactly its cycle
                stranded = [c for c in f.onsets if not 0 < c < cycles]
                if stranded:
                    report.add(
                        PASS, "CAP_EPOCH", "error", where,
                        f"fault onsets {stranded} outside (0, {cycles}): "
                        f"the epoch never resolves inside the run")
                else:
                    report.add(
                        PASS, "CAP_EPOCH", "info", where,
                        f"superstep K={k} cannot skip the "
                        f"{len(f.onsets)} onset(s) {f.onsets}: the "
                        f"unrolled body resolves the fault epoch per "
                        f"substep, so each onset lands on its exact "
                        f"cycle even mid-superstep")


def check_scenario(name: str, report) -> None:
    check_spec(get_scenario(name), f"scenario:{name}", report)
