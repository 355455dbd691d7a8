"""K-cycle supersteps, the cycle index as a device tensor, the
sequential-lane form and the graph runner's static buffers, on the CPU.

The port's three steps at K in {1, 2, 4} give the reference's rows field
for field on a fault grid with a warm onset at cycle 61 and a warmup
that K does not divide (62 of 180 cycles), so both land inside a
superstep (as `tests/test_compact_step.py` holds the reference); K = 7
does not divide the run and falls back to 1.  A step given a 0-d tensor
`t` equals the step given the int, state for state; the sequential lane
form equals the lockstep one; and `engine.graphs.CycleGraph`, the
runner the card replays as a CUDA graph, run eagerly here on its static
buffers, equals the eager loop across runs that reuse it.
"""
import dataclasses

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import topology as JT
from repro.core import traffic as JTR
from repro.core.engine.sweep import superstep as jax_superstep
from repro.core.simulator import SimConfig as JConfig
from repro.core.simulator import Simulator as JSimulator
from repro_torch import random as jr
from repro_torch.core import topology as PT
from repro_torch.core import traffic as PTR
from repro_torch.core.engine import (build_lane, graphs, make_state,
                                     make_step, stack_lanes)
from repro_torch.core.engine import sweep as SW
from repro_torch.core.engine.state import with_sink_row
from repro_torch.core.engine.step import _key_chain, run_scan
from repro_torch.core.routing import share_lanes
from repro_torch.core.simulator import SimConfig, Simulator

torch.set_num_threads(1)

PARAMS = dict(a=1, b=1, m=2, n=6, noc=2, g=3)
WARMUP, MEASURE = 62, 118
OFFERED, SEEDS = 1.2, (0,)
ONSET = 61
# the engine-level tests run this far, the warmup reset at WARMUP
SHORT = 100
IMPLS = ("jnp", "fused", "compact")


def _cfg(mod, impl="jnp", **kw):
    return mod(warmup=WARMUP, measure=MEASURE, vcs_per_class=2,
               step_impl=impl, **kw)


@pytest.fixture(scope="module")
def nets():
    return (JT.build_switchless(JT.SwitchlessParams(**PARAMS), "ss"),
            PT.build_switchless(PT.SwitchlessParams(**PARAMS), "ss"))


def _grid(top, net):
    """Pristine, cold (two dead global links) and warm (the same set from
    cycle 61) rows of one package's fault grid."""
    glob = np.where(np.asarray(net.ch_type) == top.GLOBAL)[0]
    cold = top.FaultSet(dead_ch=tuple(int(c) for c in glob[:2]))
    return [top.FaultSet(), cold,
            top.FaultSchedule(((0, top.FaultSet()), (ONSET, cold)))]


def _rows(res):
    return [dataclasses.asdict(r) for r in res.flat()]


@pytest.fixture(scope="module")
def reference(nets):
    """The reference oracle's rows on the fault grid."""
    jn, _ = nets
    sim = JSimulator(jn, _cfg(JConfig), JTR.uniform(jn))
    return _rows(sim.sweep_faults(OFFERED, _grid(JT, jn), seeds=SEEDS))


def _port(nets, impl, **kw):
    pn = nets[1]
    sim = Simulator(pn, _cfg(SimConfig, impl), PTR.uniform(pn),
                    device="cpu", **kw)
    return sim.sweep_faults(OFFERED, _grid(PT, pn), seeds=SEEDS)


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("impl", IMPLS)
def test_superstep_equals_reference(nets, reference, impl, k, monkeypatch):
    monkeypatch.setenv("REPRO_SUPERSTEP", str(k))
    res = _port(nets, impl)
    assert res.superstep == k and res.compile_count == 1
    assert _rows(res) == reference


@pytest.mark.parametrize("impl", IMPLS)
def test_superstep_non_divisor_falls_back(nets, reference, impl,
                                          monkeypatch):
    monkeypatch.setenv("REPRO_SUPERSTEP", "7")      # 180 % 7 != 0
    assert SW.superstep(WARMUP + MEASURE) == 1
    res = _port(nets, impl)
    assert res.superstep == 1
    assert _rows(res) == reference


@pytest.mark.parametrize("raw", ["", "1", "2", "4", "7", "0", "-3", "x"])
def test_superstep_knob_equals_reference(raw, monkeypatch):
    monkeypatch.setenv("REPRO_SUPERSTEP", raw)
    for span in (None, 180, 181, 1500):
        assert SW.superstep(span) == jax_superstep(span)


def test_eager_loop_equals_reference(nets, reference, monkeypatch):
    """The parity yardstick, named explicitly, whatever K is set."""
    monkeypatch.setenv("REPRO_SUPERSTEP", "4")
    res = _port(nets, "fused", loop="eager")
    assert res.superstep == 1
    assert _rows(res) == reference


def _fresh(nets, impl, B=2):
    pn = nets[1]
    cfg = _cfg(SimConfig, impl, reap_age=20)
    step, consts = make_step(pn, cfg, PTR.uniform(pn), device="cpu")
    fl = share_lanes(build_lane(pn, cfg, _grid(PT, pn)[2], device="cpu"), B)
    state = make_state(pn, cfg, consts["NV"], batch=(B,), device="cpu")
    keys = torch.stack([jr.PRNGKey(s) for s in range(B)])
    rates = torch.full((B,), 0.3, dtype=torch.float32)
    return step, state, rates, keys, fl


def _clone_b(b_pkt):
    """A `make_state` b_pkt copy that keeps the spare channel row."""
    return with_sink_row(b_pkt).clone().narrow(1, 0, b_pkt.shape[1])


def _leaves(state):
    out = {k: v for k, v in vars(state).items() if k != "stats"}
    out.update(vars(state.stats))
    return out


@pytest.mark.parametrize("impl", IMPLS)
def test_tensor_t_equals_int_t(nets, impl):
    """Every state tensor after every cycle, across the warm onset and
    with the reaper on: the step given t as a 0-d int32 tensor equals the
    step given the int."""
    step, state, rates, keys, fl = _fresh(nets, impl)
    subs = _key_chain(keys, 90)
    # the steps write b_pkt and s_pkt in place: b runs on copies
    a = state
    b = state.replace(b_pkt=_clone_b(state.b_pkt), s_pkt=state.s_pkt.clone())
    for t in range(90):
        a, _ = step(a, (t, subs[t], rates, fl))
        b, _ = step(b, (torch.tensor(t, dtype=torch.int32), subs[t], rates,
                        fl))
        for k, v in _leaves(a).items():
            assert torch.equal(v, _leaves(b)[k]), (t, k)


@pytest.mark.parametrize("impl", IMPLS)
def test_sequential_form_equals_lockstep(nets, impl):
    _, pn = nets
    step, state, rates, keys, fl = _fresh(nets, impl, B=3)
    NV = state.b_head.shape[-1]
    fresh = lambda: make_state(pn, _cfg(SimConfig, impl), NV, batch=(3,),
                               device="cpu")
    lock = SW._scan_lanes(step, SHORT, WARMUP, 4, "graph", fresh(),
                          rates, keys, fl)[0]
    seq = SW._scan_lanes_seq(step, SHORT, WARMUP, 4, "graph", fresh(),
                             rates, keys, fl)[0]
    for k, v in vars(lock).items():
        assert torch.equal(v, getattr(seq, k)), k
    assert SW.lane_form(step, "cpu") == ("sequential" if impl == "compact"
                                         else "lockstep")


@pytest.mark.parametrize("impl", ["jnp", "compact"])
def test_graph_runner_buffers_equal_superstep_loop(nets, impl):
    """The CUDA graph runner's static buffers, run eagerly (nothing is
    captured on the CPU): one cached `CycleGraph` serves two runs (other
    keys and rates) and each equals the eager loop; the warmup reset lands
    mid-superstep."""
    _, pn = nets
    step, state, rates, keys, fl = _fresh(nets, impl)
    NV, cycles, K = state.b_head.shape[-1], SHORT, 4
    cfg = _cfg(SimConfig, impl)
    fresh = lambda: make_state(pn, cfg, NV, batch=(2,), device="cpu")
    graphs.clear()
    made = []
    for rep, seed in enumerate((0, 5)):
        keys = torch.stack([jr.PRNGKey(seed + s) for s in range(2)])
        rates = torch.tensor([0.2, 0.35 + 0.1 * rep])
        graph, captured = graphs.graph_for(step, K, fresh(), rates, fl)
        assert not captured and graph.graph is None
        made.append(graph)
        got = graph.run(fresh(), rates, fl, WARMUP, _key_chain(keys, cycles))
        want = run_scan(step, cycles, WARMUP, fresh(), rates, keys,
                        fl).stats
        for k, v in vars(want).items():
            assert torch.equal(v, getattr(got, k)), (rep, k)
    assert made[0] is made[1]
    graphs.clear()


def test_graph_cache_keeps_the_last_graphs(nets):
    """The cache holds the last `GRAPHS_KEPT` keys used: one more evicts
    the least recently used, which a later call then makes anew."""
    step, state, rates, keys, fl = _fresh(nets, "fused")
    graphs.clear()
    ks = range(1, graphs.GRAPHS_KEPT + 2)
    made = [graphs.graph_for(step, k, state, rates, fl)[0] for k in ks]
    assert len(set(map(id, made))) == len(made)
    assert len(graphs._GRAPHS) == graphs.GRAPHS_KEPT
    assert graphs.graph_for(step, ks[-1], state, rates, fl)[0] is made[-1]
    assert graphs.graph_for(step, 1, state, rates, fl)[0] is not made[0]
    graphs.clear()


def test_lane_signature_tells_shared_from_stacked(nets):
    _, pn = nets
    cfg = _cfg(SimConfig)
    lane = build_lane(pn, cfg, None, device="cpu")
    shared, stacked = share_lanes(lane, 2), stack_lanes([lane, lane])
    assert graphs.lane_signature(shared) != graphs.lane_signature(stacked)
    assert graphs.lane_signature(shared) == graphs.lane_signature(
        share_lanes(build_lane(pn, cfg, None, device="cpu"), 2))


def test_loop_argument_and_counters(nets):
    _, pn = nets
    cfg = _cfg(SimConfig, "fused")
    for loop in ("scan", "superstep"):
        with pytest.raises(ValueError, match="unknown loop"):
            Simulator(pn, cfg, PTR.uniform(pn), device="cpu", loop=loop)
    sim = Simulator(pn, cfg, PTR.uniform(pn), device="cpu")
    assert sim.loop == "graph"
    before = SW.compile_counter()
    lanes = [(0.4, 0, None), (1.2, 1, None)]
    plan = sim._batched.warm_compile(lanes)
    run = sim._batched.run_lanes_async(plan=plan).finish()
    with pytest.raises(ValueError, match="single-use"):
        sim._batched.run_lanes_async(plan=plan)
    assert SW.compile_counter() == before       # nothing captured on a CPU
    assert [dataclasses.asdict(r) for r in run.results] == \
        [dataclasses.asdict(r) for r in sim._batched.run_lanes(lanes).results]
    assert dataclasses.asdict(run.results[1]) == \
        dataclasses.asdict(sim.run(1.2, seed=1))
