"""Channel sharding of the port's fused step (`fused.ShardedStep`, the
sweep's ``"lanes:L,shards:K"`` dispatch) against the JAX reference's
fused run, on the CPU.

REPRO_HOST_DEVICES=4 and REPRO_CHANNEL_SHARDS=K are set in-process with
`monkeypatch` (the port reads them at call time); the reference runs its
unsharded fused step in-process, and its own tests
(`tests/test_channel_sharding.py`) pin that run equal to its sharded
one.  The three cases are the reference's: all three VC modes' fused
step, a warm `FaultSchedule` lane mix (scheduled lanes route per cycle)
and ghost channels (the dragonfly's E = 438 does not divide 4), at both
2-D shapes four devices offer.  Beyond them: a hotspot pattern (its
inject mask reaches the sharded tables), the `two_pass` grant form forced
on the sharded step (the age tie re-masked against the global per-channel
age between two exchanges), and the reaper's pops across the exchange.
Tolerance: exact, every counter of every lane.
"""
import dataclasses
import functools

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import topology as JT
from repro.core import traffic as JTR
from repro.core.engine.fused import fused_pad as ref_fused_pad
from repro.core.engine.fused import grant_form as ref_grant_form
from repro.core.simulator import SimConfig as JConfig
from repro.core.simulator import Simulator as JSimulator
from repro_torch.core import topology as PT
from repro_torch.core import traffic as PTR
from repro_torch.core.engine import sweep as SW
from repro_torch.core.engine.fused import fused_pad, grant_form
from repro_torch.core.simulator import SimConfig, Simulator

torch.set_num_threads(1)

# the reference's tests run 41 + 131 cycles; 31 + 89 keep the warm onset
# (cycle 60) inside the measured window and halve this file's time
WARMUP, MEASURE = 31, 89
CASES = ("baseline", "merged", "dragonfly_warm")


def _case(T, case):
    """(net, SimConfig keywords, lanes) of one reference case, built with
    topology module `T` (the reference's or the port's)."""
    small = dict(a=1, b=1, m=2, n=6, noc=2, g=3)
    kw = dict(warmup=WARMUP, measure=MEASURE, vcs_per_class=2,
              step_impl="fused")
    if case == "baseline":
        net = T.build_switchless(T.SwitchlessParams(**small), "chsh-b")
        kw.update(vc_mode="baseline", route_mode="min")
        return net, kw, [(r, s, None) for r in (0.4, 0.9, 1.6)
                         for s in (0, 1)]
    if case == "merged":
        net = T.build_switchless(T.SwitchlessParams(**small), "chsh-m")
        kw.update(vc_mode="updown_merged", route_mode="min")
        return net, kw, [(0.5, 0, None), (1.2, 1, None)]
    net = T.build_switch_dragonfly(T.paper_radix16_dragonfly(g=3))
    kw.update(vc_mode="updown", route_mode="val")
    glob = np.where(np.asarray(net.ch_type) == T.GLOBAL)[0]
    f = T.FaultSchedule((
        (0, T.FaultSet()),
        (60, T.FaultSet(dead_ch=frozenset(int(c) for c in glob[:2])))))
    return net, kw, [(0.4, 0, None), (0.9, 1, f), (1.6, 0, f)]


def _traffic(TR, net, traffic):
    """Traffic module `TR`'s pattern: uniform, or hotspot on 2 of the 3
    W-groups (32 of 48 terminals inject)."""
    return (TR.uniform(net) if traffic == "uniform"
            else TR.hotspot(net, num_hot=2))


def _rows(results):
    return [dataclasses.asdict(r) for r in results]


@functools.lru_cache(maxsize=None)
def _reference(case, traffic="uniform"):
    net, kw, lanes = _case(JT, case)
    run = JSimulator(net, JConfig(**kw), _traffic(JTR, net, traffic)) \
        ._batched.run_lanes(lanes)
    assert run.placement == "single"
    return _rows(run.results)


def _sharded_sweep(monkeypatch, case, shards, traffic="uniform"):
    """(the port's sweep of `case`, its lanes) with 4 logical devices and
    K = `shards` channel shards."""
    monkeypatch.setenv("REPRO_HOST_DEVICES", "4")
    monkeypatch.setenv("REPRO_CHANNEL_SHARDS", str(shards))
    net, kw, lanes = _case(PT, case)
    sim = Simulator(net, SimConfig(**kw), _traffic(PTR, net, traffic),
                    device="cpu")
    return sim._batched, lanes


@pytest.mark.parametrize("shards,placement", [(2, "lanes:2,shards:2"),
                                              (4, "lanes:1,shards:4")])
@pytest.mark.parametrize("case", CASES)
def test_channel_sharded_equals_the_reference(monkeypatch, case, shards,
                                              placement):
    """The 2-D dispatch reproduces the reference's fused run bit for bit,
    with the reference's placement string and pad fraction (its formula
    over its own `fused_pad`; > 0 on the dragonfly), on the eager loop."""
    sweep, lanes = _sharded_sweep(monkeypatch, case, shards)
    run = sweep.run_lanes(lanes)
    jnet, kw, _ = _case(JT, case)
    B, rows = len(lanes), 4 // shards
    ch_pad = ref_fused_pad(jnet, shards)[0]
    E = jnet.num_channels
    pad = (-B) % rows
    assert run.placement == placement
    assert run.pad_fraction == 1.0 - (B * E) / ((B + pad) * (E + ch_pad))
    assert (run.pad_fraction > 0) == (case == "dragonfly_warm")
    assert run.loop == "eager" and run.compile_count == 1
    assert run.grant_form == ref_grant_form(jnet, JConfig(**kw), shards)
    assert _rows(run.results) == _reference(case)


@pytest.mark.parametrize("shards", [2, 4])
def test_hotspot_inject_mask_equals_the_reference(monkeypatch, shards):
    """A pattern that carries an inject mask (hotspot) builds each shard's
    mask and reproduces the reference's fused run bit for bit."""
    sweep, lanes = _sharded_sweep(monkeypatch, "baseline", shards,
                                  "hotspot")
    run = sweep.run_lanes(lanes)
    assert run.placement == ("lanes:2,shards:2" if shards == 2
                             else "lanes:1,shards:4")
    assert _rows(run.results) == _reference("baseline", "hotspot")


@pytest.mark.parametrize("shards", [2, 4])
def test_two_pass_form_equals_the_reference(monkeypatch, shards):
    """The sharded step's `two_pass` form, forced at a cycle count where
    the packed key fits: the age minimum is exchanged, each shard re-masks
    its rows against that GLOBAL per-channel age, and the priority minimum
    is exchanged in turn.  It picks the combined form's winners, so the
    rows are the reference's fused rows (ghost channels and scheduled
    lanes included)."""
    sweep, lanes = _sharded_sweep(monkeypatch, "dragonfly_warm", shards)
    step = sweep._step_for(SW.lane_mesh(shards, sweep.device)[0], shards)
    assert step.form == "combined"
    step.form = "two_pass"
    run = sweep.run_lanes(lanes)
    assert run.placement == ("lanes:2,shards:2" if shards == 2
                             else "lanes:1,shards:4")
    assert _rows(run.results) == _reference("dragonfly_warm")


@pytest.mark.parametrize("case", CASES)
def test_grant_form_and_pad_match_the_reference(case):
    """`grant_form(net, cfg, K)` and `fused_pad(net, K)` are the
    reference's for K in 1, 2, 4, at these runs' cycles and where the
    padded modulus overflows the packed key."""
    jnet, kw, _ = _case(JT, case)
    pnet = _case(PT, case)[0]
    for measure in (MEASURE, 2_000_000):
        kw = dict(kw, measure=measure)
        for K in (1, 2, 4):
            assert grant_form(pnet, SimConfig(**kw), K) == \
                ref_grant_form(jnet, JConfig(**kw), K)
            assert fused_pad(pnet, K) == ref_fused_pad(jnet, K)


def test_channel_shards_knob_ignored_on_jnp_step(monkeypatch):
    """REPRO_CHANNEL_SHARDS applies to fused dispatches only: the oracle
    step spreads lanes (1-D) and never shards channels."""
    monkeypatch.setenv("REPRO_HOST_DEVICES", "4")
    monkeypatch.setenv("REPRO_CHANNEL_SHARDS", "2")
    monkeypatch.setenv("REPRO_SHARD_MIN_WORK", "0")
    assert SW.channel_shards() == 2
    net, kw, lanes = _case(PT, "merged")
    kw = dict(kw, step_impl="jnp", measure=20, warmup=5)
    run = Simulator(net, SimConfig(**kw), PTR.uniform(net),
                    device="cpu")._batched.run_lanes(lanes)
    assert run.placement == "lanes:4" and run.loop == "graph"
    monkeypatch.delenv("REPRO_CHANNEL_SHARDS")
    assert SW.channel_shards() == 1


def test_channel_shards_need_enough_devices(monkeypatch):
    """Fewer devices than K: no channel sharding; K not dividing the
    devices: ValueError."""
    net, kw, lanes = _case(PT, "merged")
    kw = dict(kw, measure=20, warmup=5)
    sweep = Simulator(net, SimConfig(**kw), PTR.uniform(net),
                      device="cpu")._batched
    monkeypatch.setenv("REPRO_HOST_DEVICES", "2")
    monkeypatch.setenv("REPRO_CHANNEL_SHARDS", "4")
    assert sweep.run_lanes(lanes).placement == "single"
    monkeypatch.setenv("REPRO_HOST_DEVICES", "4")
    monkeypatch.setenv("REPRO_CHANNEL_SHARDS", "3")
    with pytest.raises(ValueError, match="does not divide"):
        sweep.run_lanes(lanes)


def test_reaper_pops_cross_the_exchange(monkeypatch):
    """Warm router death with the reaper on (the reference's cases run it
    off): the shard that owns a reaped row exchanges its pop, and the
    sharded run equals the reference's fused run of the same lanes, and
    the port's unsharded run."""
    def case(T):
        net = T.build_switchless(
            T.SwitchlessParams(a=1, b=1, m=2, n=6, noc=2, g=3), "chsh-r")
        f = T.FaultSchedule(((0, T.FaultSet()),
                             (60, T.FaultSet((), (5, 11)))))
        return net, [(0.4, 0, f), (1.2, 1, f), (1.2, 0, None)]

    kw = dict(warmup=40, measure=140, vc_mode="updown", route_mode="min",
              reap_age=12, step_impl="fused")
    jnet, jlanes = case(JT)
    ref = JSimulator(jnet, JConfig(**kw), JTR.uniform(jnet))._batched \
        .run_lanes(jlanes)
    net, lanes = case(PT)
    sweep = Simulator(net, SimConfig(**kw), PTR.uniform(net),
                      device="cpu")._batched
    want = sweep.run_lanes(lanes)
    monkeypatch.setenv("REPRO_HOST_DEVICES", "2")
    monkeypatch.setenv("REPRO_CHANNEL_SHARDS", "2")
    got = sweep.run_lanes(lanes)
    assert got.placement == "lanes:1,shards:2" and want.placement == "single"
    assert sum(r.reaped_pkts for r in got.results) > 0, "vacuous"
    assert _rows(got.results) == _rows(ref.results)
    assert _rows(want.results) == _rows(ref.results)
