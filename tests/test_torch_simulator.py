"""Parity of the port's `Simulator` facade and batched sweep with the JAX
reference, lane for lane, plus the port's package rules.

Covers the library-boundary checks of the verify recipe (§4: a (rate x
seed) grid equals sequential runs; §5: a degraded-wafer fault grid in
one dispatch), mixed cold/warm fault grids on a faulted base network
with the reaper on, every traffic pattern's destinations and inject
masks, the device rule (no silent CPU fallback), and an import scan
that keeps `jax` and the reference package out of the port.
"""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import jax
import pytest
torch = pytest.importorskip("torch")

from repro.core import topology as JT
from repro.core import traffic as JTR
from repro.core.simulator import SimConfig as JConfig
from repro.core.simulator import Simulator as JSimulator
from repro_torch import random as jr
from repro_torch.core import topology as PT
from repro_torch.core import traffic as PTR
from repro_torch.core.engine import BatchedSweep
from repro_torch.core.simulator import SimConfig, Simulator

# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _pair(**p):
    return (JT.build_switchless(JT.SwitchlessParams(**p), "x"),
            PT.build_switchless(PT.SwitchlessParams(**p), "x"))


def _same_grid(a, b):
    assert len(a.results) == len(b.results)
    for ra, rb in zip(a.flat(), b.flat()):
        assert dataclasses.asdict(ra) == dataclasses.asdict(rb)


def _port_faults(f):
    if f is None or isinstance(f, JT.FaultSet):
        return f if f is None else PT.FaultSet(f.dead_ch, f.dead_routers)
    return PT.FaultSchedule(tuple((c, _port_faults(g)) for c, g in f.epochs))


def test_sweep_grid_lane_for_lane_and_matches_run():
    """Verify recipe §4 on both packages."""
    jn, pn = _pair(a=1, b=1, m=2, n=6, noc=2, g=1)
    over = dict(warmup=100, measure=400)
    jgrid = JSimulator(jn, JConfig(**over), JTR.uniform(jn)).sweep_grid(
        [0.2, 0.4], seeds=(0, 1))
    sim = Simulator(pn, SimConfig(**over), PTR.uniform(pn), device="cpu")
    grid = sim.sweep_grid([0.2, 0.4], seeds=(0, 1))
    _same_grid(jgrid, grid)
    assert grid.compile_count == 1
    assert dataclasses.asdict(grid.result(1, 0)) \
        == dataclasses.asdict(sim.run(0.4, seed=0))
    want = [dataclasses.asdict(r) for r in jgrid.mean_over_seeds()]
    assert want == [dataclasses.asdict(r) for r in grid.mean_over_seeds()]
    assert jgrid.saturation_throughput() == grid.saturation_throughput()


def test_sweep_faults_one_dispatch():
    """Verify recipe §5 on both packages."""
    jn, pn = _pair(a=1, b=2, m=2, n=4, noc=2, g=4)
    over = dict(warmup=100, measure=400, vc_mode="updown")
    f = JT.sample_link_faults(jn, 0.1, np.random.default_rng(7))
    jres = JSimulator(jn, JConfig(**over), JTR.uniform(jn)).sweep_faults(
        0.3, [[JT.FaultSet()], [f]], seeds=(0,))
    res = Simulator(pn, SimConfig(**over), PTR.uniform(pn),
                    device="cpu").sweep_faults(
        0.3, [[PT.FaultSet()], [_port_faults(f)]], seeds=(0,))
    assert res.compile_count == 1 and res.result(1, 0).delivered_pkts > 0
    _same_grid(jres, res)
    assert jres.fault_fracs == res.fault_fracs


def test_mixed_cold_warm_grid_on_faulted_base_with_reaper():
    """Cold sets promoted to schedules beside warm ones, every lane
    composed on a faulted base network, reaper on, several seeds."""
    jn, pn = _pair(a=1, b=2, m=2, n=4, noc=2, g=4)
    over = dict(warmup=40, measure=120, vc_mode="updown", route_mode="ugal",
                reap_age=15)
    rng = np.random.default_rng(3)
    base = JT.sample_link_faults(jn, 0.05, rng)
    dead = JT.sample_router_faults(jn, 2, rng, base=base)
    grid = [JT.FaultSet(), dead,
            JT.FaultSchedule(((0, JT.FaultSet()), (50, dead))),
            JT.FaultSchedule(((0, JT.FaultSet()), (30, dead),
                              (90, JT.FaultSet())))]
    jres = JSimulator(jn, JConfig(**over), JTR.uniform(jn),
                      faults=base).sweep_faults(0.5, grid, seeds=(0, 1))
    res = Simulator(pn, SimConfig(**over), PTR.uniform(pn),
                    faults=_port_faults(base), device="cpu").sweep_faults(
        0.5, [_port_faults(f) for f in grid], seeds=(0, 1))
    _same_grid(jres, res)
    assert sum(r.reaped_pkts for r in res.flat()) > 0


PATTERNS = [("uniform", {}), ("bit_reverse", {}), ("bit_shuffle", {}),
            ("bit_transpose", {}), ("worst_case", {}),
            ("hotspot", dict(num_hot=2, seed=1)), ("ring_allreduce", {}),
            ("ring_allreduce", dict(bidirectional=True))]


@pytest.mark.parametrize("name,params", PATTERNS)
def test_traffic_patterns(name, params):
    """Destinations per key and cycle, and inject masks, per pattern; a
    leading key dimension is the reference's `vmap` over lanes."""
    jn, pn = _pair(a=2, b=2, m=2, n=4, noc=2, g=3)
    jp = JTR.make_pattern(jn, name, **params)
    pp = PTR.make_pattern(pn, name, **params)
    if jp.inject_mask is None:
        assert pp.inject_mask is None
    else:
        assert (np.asarray(jp.inject_mask) == pp.inject_mask).all()
    seeds = (0, 1, 2)
    want = np.stack([np.asarray(jp(jax.random.PRNGKey(s), 5))
                     for s in seeds])
    got = PTR.batched(pp)(torch.stack([jr.PRNGKey(s) for s in seeds]), 5)
    assert got.shape == want.shape and (want == got.numpy()).all()


def test_device_rule_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, pn = _pair(a=1, b=1, m=2, n=6, noc=2, g=1)
    cfg = SimConfig(warmup=1, measure=1)
    for make in (Simulator, BatchedSweep):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(pn, cfg, PTR.uniform(pn))


def test_config_validation_and_unported_steps():
    _, pn = _pair(a=1, b=1, m=2, n=6, noc=2, g=1)
    with pytest.raises(ValueError, match="grant_impl"):
        SimConfig(grant_impl="magic")
    with pytest.raises(ValueError, match="step_impl"):
        SimConfig(step_impl="warp")
    # the fused step's channel sharding builds, and its first cycles are
    # the unsharded step's, every state leaf
    from repro_torch.core.engine.fused import make_fused_step
    from repro_torch.core.engine.state import build_lane, make_state
    from repro_torch.core.routing import share_lanes
    cfg = SimConfig(step_impl="fused")
    step, consts = make_fused_step(pn, cfg, PTR.uniform(pn), device="cpu")
    sstep, _ = make_fused_step(pn, cfg, PTR.uniform(pn), shards=2,
                               device="cpu")
    state = make_state(pn, cfg, consts["NV"], batch=(2,), device="cpu")
    states = sstep.make_states((2,))
    fl = share_lanes(build_lane(pn, cfg, None, device="cpu"), 2)
    rate = torch.tensor([0.6, 1.0])
    for t in range(12):
        key = torch.stack([jr.PRNGKey(t), jr.PRNGKey(t + 100)])
        state, _ = step(state, (t, key, rate, fl))
        states, _ = sstep(states, (t, sstep.place(key), sstep.place(rate),
                                   sstep.place(fl)))
    got = sstep.gather(states)
    for k in ("b_pkt", "b_head", "b_count", "s_pkt", "s_head", "s_count",
              "ch_busy"):
        assert torch.equal(getattr(got, k), getattr(state, k)), k
    for k, v in vars(state.stats).items():
        assert torch.equal(getattr(got.stats, k), v), k
    assert int(state.stats.delivered.sum()) > 0
    # both reference grant names run the one arbitration of the port, in
    # every step, and all steps agree
    res = [Simulator(pn, SimConfig(warmup=5, measure=30, grant_impl=g,
                                   step_impl=impl),
                     PTR.uniform(pn), device="cpu").run(0.5)
           for g in ("jnp", "pallas")
           for impl in ("jnp", "fused", "compact")]
    assert all(dataclasses.asdict(r) == dataclasses.asdict(res[0])
               for r in res)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{f}: {mod}"
