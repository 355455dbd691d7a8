"""Lane sharding in the port (`repro_torch.core.engine.sweep`) against the
JAX reference, on the CPU.

The port reads REPRO_HOST_DEVICES at call time, so `monkeypatch.setenv`
splits the CPU into logical devices in-process (`device.host_devices`);
the reference runs single-device in-process, and its own tests
(`tests/test_lane_sharding.py`) pin that run equal to its sharded one.
B = 6 lanes on 4 devices exercises the ghost-lane padding (6 % 4 != 0).
Tolerance: exact, every counter of every lane.
"""
import dataclasses
import functools

import pytest
torch = pytest.importorskip("torch")

from repro.core import topology as JT
from repro.core import traffic as JTR
from repro.core.simulator import SimConfig as JConfig
from repro.core.simulator import Simulator as JSimulator
from repro_torch.core import topology as PT
from repro_torch.core import traffic as PTR
from repro_torch.core.engine import sweep as SW
from repro_torch.core.simulator import SimConfig, Simulator
from repro_torch.device import host_devices, physical_device

torch.set_num_threads(1)

RATES = [0.4, 0.9, 1.6]
SEEDS = (0, 1)
WARMUP, MEASURE = 43, 167
PARAMS = dict(a=1, b=1, m=2, n=6, noc=2, g=1)
LANES = [(r, s, None) for r in RATES for s in SEEDS]


def _rows(results):
    return [dataclasses.asdict(r) for r in results]


@functools.lru_cache(maxsize=None)
def _reference():
    """The reference's oracle grid; its fused and compact steps are bit
    for bit the oracle (its own tests), so every step is held to this."""
    net = JT.build_switchless(JT.SwitchlessParams(**PARAMS), "shard-seq")
    cfg = JConfig(warmup=WARMUP, measure=MEASURE, vcs_per_class=2)
    grid = JSimulator(net, cfg, JTR.uniform(net)).sweep_grid(RATES,
                                                             seeds=SEEDS)
    return _rows(grid.flat())


def _sim(impl="jnp"):
    net = PT.build_switchless(PT.SwitchlessParams(**PARAMS), "shard-par")
    cfg = SimConfig(warmup=WARMUP, measure=MEASURE, vcs_per_class=2,
                    step_impl=impl)
    return Simulator(net, cfg, PTR.uniform(net), device="cpu")


def test_sharded_non_multiple_lanes_equal_the_reference(monkeypatch):
    """6 lanes on 4 logical devices (ghost-padded to 8): "lanes:4",
    pad_fraction 0.25, one step run through, and the reference's
    counters lane for lane.  REPRO_SHARD_MIN_WORK=0 lifts the small-grid
    gate."""
    monkeypatch.setenv("REPRO_HOST_DEVICES", "4")
    monkeypatch.setenv("REPRO_SHARD_MIN_WORK", "0")
    grid = _sim().sweep_grid(RATES, seeds=SEEDS)
    assert grid.placement == "lanes:4"
    assert grid.pad_fraction == 0.25
    assert grid.compile_count == 1 and grid.loop == "graph"
    assert _rows(grid.flat()) == _reference()


def test_small_grid_stays_single_device(monkeypatch):
    """The min-work gate: under REPRO_SHARD_MIN_WORK lane-cycles (default
    4,096) the grid runs on one device even with four."""
    monkeypatch.setenv("REPRO_HOST_DEVICES", "4")
    grid = _sim().sweep_grid(RATES, seeds=SEEDS)
    assert grid.placement == "single" and grid.pad_fraction == 0.0
    assert _rows(grid.flat()) == _reference()


def test_pinned_run_is_single(monkeypatch):
    """An explicit device pins the whole run there, whatever the work."""
    monkeypatch.setenv("REPRO_HOST_DEVICES", "4")
    monkeypatch.setenv("REPRO_SHARD_MIN_WORK", "0")
    run = _sim()._batched.run_lanes(LANES, device=torch.device("cpu", 2))
    assert run.placement == "single" and run.pad_fraction == 0.0
    assert _rows(run.results) == _reference()


def test_sharded_session_equals_the_one_shot_run(monkeypatch):
    """A windowed session sharded the same way ("lanes:4", 2 ghost
    lanes) finishes with the one-shot counters; exported after two
    windows and restored into a fresh session, it does too."""
    monkeypatch.setenv("REPRO_HOST_DEVICES", "4")
    monkeypatch.setenv("REPRO_SHARD_MIN_WORK", "0")
    sweep = _sim()._batched
    ses = sweep.start_lanes(LANES, window=64)
    assert ses.placement == "lanes:4" and ses.pad_fraction == 0.25
    assert [ch.hi - ch.lo for ch in ses.chunks] == [2, 2, 2, 2]
    snap, windows = None, 0
    while not ses.done():
        ses.advance()
        windows += 1
        if windows == 2:
            snap = ses.export()
    assert snap["state"].b_head.shape[0] == 8
    assert _rows(ses.finish().results) == _reference()
    again = sweep.start_lanes(LANES, window=64, restore=snap)
    while not again.done():
        again.advance()
    assert _rows(again.finish().results) == _reference()


def test_compact_escalation_keeps_the_placement(monkeypatch):
    """A compact grid pinned below its live peak escalates and re-runs
    the whole grid with the same placement; the counters are the
    reference's (seed 0's three lanes, one ghost)."""
    monkeypatch.setenv("REPRO_HOST_DEVICES", "4")
    monkeypatch.setenv("REPRO_SHARD_MIN_WORK", "0")
    lanes = [(r, SEEDS[0], None) for r in RATES]
    run = _sim("compact")._batched.run_lanes_async(lanes,
                                                   capacity=5).finish()
    assert run.placement == "lanes:4" and run.escalations == 1
    assert run.compact_capacity > 5
    assert _rows(run.results) == _reference()[::len(SEEDS)]


def test_repro_host_devices_knob(monkeypatch):
    """The knob splits the CPU into logical devices, parsed strictly;
    their tensors land on the one CPU."""
    monkeypatch.delenv("REPRO_HOST_DEVICES", raising=False)
    assert host_devices("cpu") == [torch.device("cpu")]
    monkeypatch.setenv("REPRO_HOST_DEVICES", "3")
    devs = host_devices("cpu")
    assert devs == [torch.device("cpu", i) for i in range(3)]
    assert {physical_device(d) for d in devs} == {torch.device("cpu")}
    t = torch.zeros(2, device=devs[1])
    assert t.device == torch.device("cpu") != devs[1]
    for bad in ("many", "0", "-2", "1.5"):
        monkeypatch.setenv("REPRO_HOST_DEVICES", bad)
        with pytest.raises(ValueError, match="REPRO_HOST_DEVICES"):
            host_devices("cpu")


def test_lane_mesh(monkeypatch):
    """One device opts out of the mesh; four give four lane rows, or two
    rows of two channel shards; a shard count that does not divide the
    devices raises, as the reference's mesh does."""
    monkeypatch.delenv("REPRO_HOST_DEVICES", raising=False)
    assert SW.lane_mesh(device="cpu") is None
    monkeypatch.setenv("REPRO_HOST_DEVICES", "4")
    assert [len(r) for r in SW.lane_mesh(device="cpu")] == [1, 1, 1, 1]
    assert SW.lane_mesh(2, device="cpu") == [
        [torch.device("cpu", 0), torch.device("cpu", 1)],
        [torch.device("cpu", 2), torch.device("cpu", 3)]]
    with pytest.raises(ValueError, match="REPRO_CHANNEL_SHARDS=3"):
        SW.lane_mesh(3, device="cpu")
