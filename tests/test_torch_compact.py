"""Per-cycle parity of the port's occupancy-compacted step
(`step_impl="compact"`) with the JAX reference's, and its capacity
ladder.

After EVERY cycle every `SimState` array and `SimStats` counter equals
the reference compact step's across the reference's
`tests/test_compact_step.py` cases on pristine, cold and warm lanes,
with both reference grants (jnp and the Pallas `cycle_core` in
interpret mode), with the reaper on, and at a capacity pinned below the
live-row peak, where both steps drop the same overflowing rows.  The
sweep layer's escalation (`_PendingLanes.finish`) re-runs such a grid at
the next rung and must then equal the oracle, start later calls at the
escalated rung, and still escalate explicit pins.
"""
import numpy as np
import pytest
import torch

from repro.core import topology as JT
from repro.core import traffic as JTR
from repro.core.engine import fused as jax_fused
from repro.core.simulator import SimConfig as JConfig
from repro.core.simulator import Simulator as JSimulator
from repro_torch.core import topology as PT
from repro_torch.core import traffic as PTR
from repro_torch.core.engine.fused import (capacity_ladder, compact_rows,
                                           initial_capacity,
                                           make_compact_step, next_rung)
from repro_torch.core.simulator import SimConfig, Simulator
from test_torch_fused import MEASURE, PARAMS, RATES, SEEDS, WARMUP, \
    run_parity

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def nets():
    return (JT.build_switchless(JT.SwitchlessParams(**PARAMS), "compact"),
            PT.build_switchless(PT.SwitchlessParams(**PARAMS), "compact"))


# the reference's tests/test_compact_step.py CASES
CASES = [("baseline", "min", 2), ("baseline", "ugal", 1),
         ("updown", "val", 2)]


@pytest.mark.parametrize("vc_mode,route_mode,vpc", CASES)
@pytest.mark.parametrize("kind", ["pristine", "cold", "warm"])
def test_compact_step_parity_per_cycle(nets, vc_mode, route_mode, vpc,
                                       kind):
    ps = run_parity(nets, dict(vc_mode=vc_mode, route_mode=route_mode,
                               vcs_per_class=vpc, step_impl="compact"),
                    kind)
    N = compact_rows(nets[1], SimConfig(vc_mode=vc_mode,
                                        route_mode=route_mode,
                                        vcs_per_class=vpc))
    assert int(ps.stats.occ_peak.max()) <= initial_capacity(N)


def test_compact_step_parity_with_reaper(nets):
    ps = run_parity(nets, dict(vc_mode="updown", route_mode="min",
                               reap_age=12, step_impl="compact"), "warm",
                    grant_impls=("jnp",))
    assert int(ps.stats.reaped.sum()) > 0, "vacuous: nothing reaped"


@pytest.mark.parametrize("kind", ["pristine", "warm"])
def test_compact_step_parity_when_capacity_overflows(nets, kind):
    """C = 50 is below the live peak: both steps keep the first 50 live
    rows and drop the rest, cycle for cycle."""
    ps = run_parity(nets, dict(step_impl="compact"), kind,
                    grant_impls=("jnp",), capacity=50)
    assert int(ps.stats.occ_peak.max()) > 50, "vacuous: no overflow"


def _rows(results):
    return [(r.delivered_pkts, r.generated_pkts, r.dropped_pkts,
             r.avg_latency, r.throughput_per_chip, r.stranded_pkts,
             r.occupancy_peak, tuple(sorted(r.hops_by_type.items())))
            for r in results]


@pytest.fixture(scope="module")
def oracle(nets):
    """The reference oracle's (jnp) grid on the default config."""
    jnet, _ = nets
    cfg = JConfig(warmup=WARMUP, measure=MEASURE, vcs_per_class=2)
    return JSimulator(jnet, cfg, JTR.uniform(jnet)).sweep_grid(
        list(RATES), seeds=SEEDS)


def _sim(pnet, impl):
    cfg = SimConfig(warmup=WARMUP, measure=MEASURE, vcs_per_class=2,
                    step_impl=impl)
    return Simulator(pnet, cfg, PTR.uniform(pnet), device="cpu")


def test_compact_telemetry_and_ladder(nets, oracle):
    """`SweepResult` carries the compact telemetry: the oracle's
    occupancy peak, the default starting rung, no escalation."""
    _, pnet = nets
    g = _sim(pnet, "compact").sweep_grid(list(RATES), seeds=SEEDS)
    N = compact_rows(pnet, SimConfig(vcs_per_class=2))
    assert g.compact_capacity == initial_capacity(N)
    assert g.compact_capacity in capacity_ladder(N)
    assert 0 < g.occupancy_peak == oracle.occupancy_peak
    assert g.occupancy_peak <= g.compact_capacity
    assert g.escalations == 0 and g.escalation_compiles == 0
    assert g.superstep == 1 and g.grant_form == "combined"
    assert _rows(g.flat()) == _rows(oracle.flat())
    jnp_grid = _sim(pnet, "jnp").sweep_grid([RATES[0]], seeds=SEEDS[:1])
    assert jnp_grid.compact_capacity == 0
    assert jnp_grid.grant_form == "two_pass"


@pytest.mark.parametrize("N", [1, 2, 7, 8, 9, 1776, 204672])
def test_ladder_algebra_matches_reference(N, monkeypatch):
    assert capacity_ladder(N) == jax_fused.capacity_ladder(N)
    assert capacity_ladder(N)[-1] == N
    for floor in (1, N // 3, N - 1, N, N + 5):
        assert next_rung(N, floor) == jax_fused.next_rung(N, floor)
    assert next_rung(N, N + 5) == N
    assert next_rung(N, 1) == capacity_ladder(N)[0]
    for cap in ("", "1", str(N // 2 + 1), str(10 * N), "junk"):
        monkeypatch.setenv("REPRO_COMPACT_CAP", cap)
        assert initial_capacity(N) == jax_fused.initial_capacity(N)


def test_capacity_escalation_bit_identical(nets, oracle):
    """A capacity pinned below the live-row peak is detected and the
    whole grid re-run at the next rung; the result is the oracle's.
    Later calls start at the escalated rung; explicit pins still
    escalate."""
    _, pnet = nets
    sweep = _sim(pnet, "compact")._batched
    lanes = [(r, s, None) for r in RATES for s in SEEDS]
    run = sweep.run_lanes_async(lanes, capacity=50).finish()
    assert _rows(run.results) == _rows(oracle.flat())
    assert run.escalations == 1
    assert run.occupancy_peak > 50
    N = sweep.step.compact_rows
    assert run.compact_capacity == next_rung(N, run.occupancy_peak)
    assert run.compile_count == 1 and run.escalation_compiles == 1
    redo = sweep.run_lanes_async(lanes, capacity=50).finish()
    again = sweep.run_lanes_async(lanes).finish()
    assert again.escalations == 0
    assert again.compact_capacity == run.compact_capacity
    assert redo.escalations == 1
    assert _rows(again.results) == _rows(redo.results) == _rows(run.results)


def test_capacity_bounds_validated(nets):
    _, pnet = nets
    cfg = SimConfig(step_impl="compact", vcs_per_class=2)
    for bad in (0, 10 ** 9):
        with pytest.raises(ValueError, match="capacity"):
            make_compact_step(pnet, cfg, PTR.uniform(pnet), capacity=bad,
                              device="cpu")
    step, _ = make_compact_step(pnet, cfg, PTR.uniform(pnet), capacity=1,
                                device="cpu")
    assert step.compact_capacity == 1
    assert step.compact_rows == compact_rows(pnet, cfg)


@pytest.mark.parametrize("impl", ["fused", "compact"])
def test_simulator_run_matches_reference(nets, impl, monkeypatch):
    """`Simulator.run` (one lane, no sweep) equals the reference's.  For
    "compact" both run the step at its starting rung, pinned here to the
    bottom one, and neither escalates."""
    jnet, pnet = nets
    monkeypatch.setenv("REPRO_COMPACT_CAP", "1")
    kw = dict(warmup=WARMUP, measure=MEASURE, step_impl=impl)
    got = Simulator(pnet, SimConfig(**kw), PTR.uniform(pnet),
                    device="cpu").run(RATES[1], seed=0)
    want = JSimulator(jnet, JConfig(**kw), JTR.uniform(jnet)).run(
        RATES[1], seed=0)
    assert _rows([got]) == _rows([want])
    assert got.delivered_pkts > 0 and np.isfinite(got.avg_latency)
