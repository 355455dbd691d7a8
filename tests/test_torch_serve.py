"""The port's windowed lane sessions, simulation service and checkpoints
(`repro_torch.core.engine.sweep.LaneSession`, `repro_torch.exp.serve`,
`repro_torch.checkpoint`), on the CPU.

The reference's serve tests (`tests/test_serve.py`) run against the port:
graphs made == distinct buckets, packed == the batch runner, tenant
fairness, kill and resume byte for byte, resume without a snapshot
raises.  The port's service JSONL after its meta line is byte for byte
the reference service's for the same submissions and window.  A
`LaneSession` equals the one-shot run: windowed, exported and restored
mid-run, with a last window whose tail is not a multiple of K = 4 (and
the graphs that costs), with ghost lanes, a forced stacked fault axis
and forced epochs; a compact session pinned below its live peak raises.
Snapshots round-trip exactly.  Tolerance: exact.
"""
import dataclasses
import io
import json

import numpy as np
import pytest
import torch

from repro.exp import get_scenario as ref_scenario
from repro.exp.serve import SimService as RefService
from repro_torch.checkpoint import (Checkpointer, restore_sim_state,
                                    save_sim_state)
from repro_torch.core import topology as T
from repro_torch.core import traffic
from repro_torch.core.engine import graphs
from repro_torch.core.engine.sweep import BatchedSweep
from repro_torch.core.simulator import SimConfig
from repro_torch.exp import clear_caches, get_scenario, run_experiment
from repro_torch.exp.serve import (SimService, clear_serve_caches,
                                   lower_request)
from repro_torch.exp.serve import cli as serve_cli
from repro_torch.exp.serve import service as service_mod

torch.set_num_threads(1)

CPU = "cpu"
# lanes a pack (the reference's tests use the default 8; 4 keeps the ghost
# lanes, and this file's time, down without changing any lane's counters)
PACK = 4
SMALL = dict(a=2, b=2, m=2, n=4, noc=2, g=3)
SMOKE_NET = dict(a=1, b=1, m=2, n=6, noc=2, g=1)


def _submit_all(svc, named):
    """[(tenant, scenario)] -> {rid: (tenant, scenario)}."""
    return {svc.submit(get_scenario(s), tenant=t): (t, s)
            for t, s in named}


def _records(text):
    return [json.loads(line) for line in text.splitlines() if line]


def _asdicts(results):
    return [dataclasses.asdict(r) for r in results]


# ---------------------------------------------------------------------------
# the reference's serve tests, on the port
# ---------------------------------------------------------------------------

def test_bucketing_graphs_equal_distinct_signatures():
    """Three requests, two signatures: the second `smoke` (another
    tenant) shares the first's bucket graph, so the run makes two."""
    clear_caches()
    clear_serve_caches()
    graphs.clear()
    specs = [("alice", "smoke"), ("bob", "smoke"),
             ("carol", "smoke_faults")]
    buckets = set()
    for rid, (t, s) in enumerate(specs, start=1):
        units, _ = lower_request(get_scenario(s), rid, t, 0)
        buckets.update(u.bucket for u in units)
    assert len(buckets) == 2
    before = graphs.builds()
    svc = SimService(window=100, pack=PACK, device=CPU)
    rids = _submit_all(svc, specs)
    svc.run()
    assert svc.idle
    assert graphs.builds() - before == len(buckets)
    for rid in rids:
        assert all(r is not None for cell in svc.results(rid)
                   for r in cell)


def test_packed_results_equal_the_batch_runner():
    svc = SimService(window=100, pack=PACK, device=CPU)
    rids = _submit_all(svc, [("alice", "smoke"), ("bob", "smoke_faults")])
    svc.run()
    for rid, (_, name) in rids.items():
        batch = run_experiment(get_scenario(name), device=CPU)
        served = svc.results(rid)
        for ci, g in enumerate(batch.grids):
            R, S = len(g.rates), len(g.seeds)
            for fi in range(len(g.fault_labels)):
                for ri in range(R):
                    for si in range(S):
                        assert (served[ci][(fi * R + ri) * S + si]
                                == g.results[fi][ri][si]), (name, ci, fi,
                                                            ri, si)


def test_small_tenant_ages_past_flooding_tenant():
    out = io.StringIO()
    svc = SimService(out=out, window=64, pack=4, max_active=2, device=CPU)
    big = [svc.submit(get_scenario("smoke"), tenant="big")
           for _ in range(4)]
    small = svc.submit(get_scenario("smoke_faults"), tenant="small")
    svc.run()
    done_order = [r["request"] for r in _records(out.getvalue())
                  if r["kind"] == "done"]
    assert set(done_order) == set(big) | {small}
    assert done_order.index(small) < done_order.index(big[-1])
    assert done_order.index(small) <= 2


def _serve_to_jsonl(path, state_dir, *, max_rounds=None, resume=False):
    if resume:
        svc = SimService.resume(str(state_dir), out=str(path), device=CPU)
    else:
        svc = SimService(out=str(path), window=100, pack=PACK,
                         state_dir=str(state_dir), checkpoint_every=1,
                         device=CPU)
        _submit_all(svc, [("alice", "smoke"),
                          ("bob", "smoke_warm_faults")])
    svc.run(max_rounds=max_rounds)
    svc.close()
    return svc


def test_kill_and_resume_byte_identical(tmp_path):
    """Killed at round 2 = cycle 200, past smoke_warm_faults' onset (151)
    and mid-run for both requests, resumed from the snapshot: the same
    bytes as the uninterrupted run, and the batch runner's results."""
    base = _serve_to_jsonl(tmp_path / "base.jsonl", tmp_path / "ck_base")
    assert base.idle
    killed = _serve_to_jsonl(tmp_path / "kr.jsonl", tmp_path / "ck",
                             max_rounds=2)
    assert not killed.idle
    resumed = _serve_to_jsonl(tmp_path / "kr.jsonl", tmp_path / "ck",
                              resume=True)
    assert resumed.idle
    assert ((tmp_path / "kr.jsonl").read_bytes()
            == (tmp_path / "base.jsonl").read_bytes())
    for rid, name in ((1, "smoke"), (2, "smoke_warm_faults")):
        g = run_experiment(get_scenario(name), device=CPU).grids[0]
        R, S = len(g.rates), len(g.seeds)
        served = resumed.results(rid)
        checked = 0
        for fi in range(len(g.fault_labels)):
            for ri in range(R):
                for si in range(S):
                    res = served[0][(fi * R + ri) * S + si]
                    if res is not None:
                        assert res == g.results[fi][ri][si]
                        checked += 1
        assert checked > 0


def test_resume_requires_snapshot(tmp_path):
    with pytest.raises(FileNotFoundError):
        SimService.resume(str(tmp_path / "nothing"), device=CPU)


def test_run_cli_jsonl_matches_the_service(tmp_path):
    from repro_torch.exp.run import main as run_main
    path = tmp_path / "batch.jsonl"
    rc = run_main(["--scenario", "smoke", "--quiet",
                   "--out", str(tmp_path / "b.json"),
                   "--jsonl", str(path)], device=CPU)
    assert rc == 0
    out = io.StringIO()
    svc = SimService(out=out, window=100, pack=PACK, device=CPU)
    svc.submit(get_scenario("smoke"), tenant="batch")
    svc.run()
    key = lambda r: (r["cell"], r["lane"])
    strip = lambda r: {k: v for k, v in r.items() if k != "request"}
    batch = {key(r): strip(r) for r in _records(path.read_text())
             if r["kind"] == "result"}
    serve = {key(r): strip(r) for r in _records(out.getvalue())
             if r["kind"] == "result"}
    assert batch == serve


def test_pack_device_single_device_is_none():
    assert service_mod.pack_device(1) is None
    assert service_mod.pack_device(7) is None


# ---------------------------------------------------------------------------
# the port's service against the reference's service
# ---------------------------------------------------------------------------

def test_service_jsonl_is_the_reference_after_the_meta_line():
    subs = [("alice", "smoke"), ("bob", "smoke"), ("carol", "smoke_faults")]
    ref_out, out = io.StringIO(), io.StringIO()
    ref = RefService(out=ref_out, window=100, pack=PACK)
    svc = SimService(out=out, window=100, pack=PACK, device=CPU)
    for tenant, name in subs:
        ref.submit(ref_scenario(name), tenant=tenant)
        svc.submit(get_scenario(name), tenant=tenant)
    ref.run()
    svc.run()
    ref_lines, lines = (o.getvalue().splitlines() for o in (ref_out, out))
    assert len(lines) == len(ref_lines) > 1
    assert lines[1:] == ref_lines[1:]
    meta = json.loads(lines[0])
    assert meta["source"] == "serve" and meta["window"] == 100
    assert meta["provenance"]["backend"] == "cpu"


def test_serve_cli_kill_and_resume(tmp_path):
    inbox = tmp_path / "inbox"
    inbox.mkdir()
    (inbox / "a.json").write_text(json.dumps(
        {"tenant": "alice", "spec": {"scenario": "smoke"}}))
    (inbox / "b.json").write_text(json.dumps(
        {"tenant": "bob", "spec": get_scenario("smoke_faults").to_dict()}))
    common = ["--quiet", "--window", "100", "--pack", str(PACK)]
    assert serve_cli.main(["--inbox", str(inbox), "--out",
                           str(tmp_path / "full.jsonl")] + common,
                          device=CPU) == 0
    assert serve_cli.main(["--inbox", str(inbox), "--out",
                           str(tmp_path / "kr.jsonl"), "--state-dir",
                           str(tmp_path / "ck"), "--max-rounds", "1"]
                          + common, device=CPU) == 3
    assert serve_cli.main(["--resume", "--state-dir", str(tmp_path / "ck"),
                           "--out", str(tmp_path / "kr.jsonl"), "--quiet"],
                          device=CPU) == 0
    full = (tmp_path / "full.jsonl").read_text().splitlines()
    kr = (tmp_path / "kr.jsonl").read_text().splitlines()
    assert kr[1:] == full[1:]
    assert serve_cli.main(["--resume", "--out", "x"], device=CPU) == 2


# ---------------------------------------------------------------------------
# LaneSession
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke_net():
    return T.build_switchless(T.SwitchlessParams(**SMOKE_NET), "ses")


@pytest.fixture(scope="module")
def small_net():
    return T.build_switchless(T.SwitchlessParams(**SMALL), "ses-small")


def _sweep(net, impl="jnp", **kw):
    cfg = SimConfig(warmup=50, measure=200, step_impl=impl, **kw)
    return BatchedSweep(net, cfg, traffic.uniform(net), device=CPU)


def _drain(session):
    while not session.done():
        session.advance()
    return session.finish()


LANES = [(0.5, 0, None), (1.5, 1, None)]


@pytest.mark.parametrize("impl", ["jnp", "fused", "compact"])
def test_windowed_equals_one_shot(smoke_net, impl):
    sw = _sweep(smoke_net, impl)
    one = sw.run_lanes(LANES)
    ses = sw.start_lanes(LANES, window=64)
    cycles = []
    while not ses.done():
        cycles.append(ses.advance())
    assert cycles == [64, 128, 192, 250]
    got = ses.finish()
    assert _asdicts(got.results) == _asdicts(one.results)
    assert got.occupancy_peak == one.occupancy_peak
    assert ses.advance() == 250          # a spent session stays put


def test_eager_session_equals_graph_session(smoke_net):
    """The eager loop (one step a host-int cycle) and the graph runner
    give one session the same counters."""
    cfg = SimConfig(warmup=50, measure=200)
    eager = BatchedSweep(smoke_net, cfg, traffic.uniform(smoke_net),
                         device=CPU, loop="eager")
    got = _drain(eager.start_lanes(LANES, window=100))
    assert _asdicts(got.results) == _asdicts(
        _sweep(smoke_net).run_lanes(LANES).results)


def test_export_restore_mid_run(small_net):
    """A warm lane (onset 120) and a cold one, exported after window 2
    (cycle 128) and restored into a fresh session of a fresh sweep."""
    glob = np.where(small_net.ch_type == T.GLOBAL)[0]
    cold = T.FaultSet(dead_ch=tuple(int(c) for c in glob[:2]))
    warm = T.FaultSchedule(((0, T.FaultSet()), (120, cold)))
    lanes = [(0.8, 0, warm), (0.8, 1, cold)]
    sw = _sweep(small_net, vc_mode="updown")
    one = sw.run_lanes(lanes)
    ses = sw.start_lanes(lanes, window=64)
    ses.advance()
    ses.advance()
    snap = ses.export()
    assert snap["cycle"] == 128 and snap["keys"].dtype == np.int64
    assert isinstance(snap["state"].b_pkt, np.ndarray)
    fresh = _sweep(small_net, vc_mode="updown")
    restored = fresh.start_lanes(lanes, window=64, restore=snap)
    assert restored.cycle == 128
    assert _asdicts(_drain(restored).results) == _asdicts(one.results)
    assert _asdicts(_drain(ses).results) == _asdicts(one.results)


def test_restore_checks_the_signature(smoke_net):
    sw = _sweep(smoke_net)
    snap = sw.start_lanes(LANES, window=100).export()
    with pytest.raises(ValueError, match="signature"):
        sw.start_lanes(LANES, window=100, pad_to=4, restore=snap)
    snap["cycle"] = 999
    with pytest.raises(ValueError, match="outside"):
        sw.start_lanes(LANES, window=100, restore=snap)


@pytest.mark.parametrize("window,graphs_made", [(100, 2), (128, 2),
                                               (125, 1)])
def test_partial_last_window_at_k4(smoke_net, monkeypatch, window,
                                   graphs_made):
    """K = 4 over the 250-cycle budget: at window 100 the last window is
    50 cycles (48 in supersteps of 4, a tail of 2 on a K = 1 graph), at
    128 it is 122 (a tail of 2); at 125 K falls back to 1 (4 does not
    divide the window).  Each gives K = 1's counters, and a session
    costs one graph a signature, two with a tail."""
    one = _sweep(smoke_net).run_lanes(LANES)
    monkeypatch.setenv("REPRO_SUPERSTEP", "4")
    graphs.clear()
    sw = _sweep(smoke_net)
    before = graphs.builds()
    ses = sw.start_lanes(LANES, window=window)
    assert ses.superstep == (4 if window % 4 == 0 else 1)
    assert ses.compile_count == graphs_made
    assert _asdicts(_drain(ses).results) == _asdicts(one.results)
    assert graphs.builds() - before == graphs_made    # nothing made later
    again = sw.start_lanes(LANES, window=window)
    assert again.compile_count == 0


def test_ghost_lanes_are_dropped(smoke_net):
    sw = _sweep(smoke_net)
    one = sw.run_lanes(LANES)
    ses = sw.start_lanes(LANES, window=100, pad_to=5)
    assert ses.num_lanes == 2 and ses.state.b_count.shape[0] == 5
    assert ses._lane_data["ch_alive"].shape[0] == 5
    assert ses._lane_data["ch_alive"].stride(0) == 0    # still shared
    assert ses.pad_fraction == pytest.approx(0.6)
    got = _drain(ses)
    assert len(got.results) == 2
    assert _asdicts(got.results) == _asdicts(one.results)
    with pytest.raises(ValueError):
        sw.start_lanes(LANES, window=100, pad_to=1)


def test_force_stack_and_epochs(smoke_net):
    """One shared fault state: shared stride-0 lanes by default, stacked
    under `force_stack`, epoch-stacked to 3 epochs under `epochs`; the
    counters never move."""
    sw = _sweep(smoke_net)
    one = sw.run_lanes(LANES)
    shared = sw.start_lanes(LANES, window=100)
    stacked = sw.start_lanes(LANES, window=100, force_stack=True)
    warm = sw.start_lanes(LANES, window=100, force_stack=True, epochs=3)
    fl = lambda s: s._lane_data["ch_alive"]
    assert fl(shared).stride(0) == 0 and fl(stacked).stride(0) != 0
    assert "epoch_start" not in stacked._lane_data
    assert tuple(warm._lane_data["epoch_start"].shape) == (2, 3)
    padded = sw.start_lanes(LANES, window=100, pad_to=3, force_stack=True,
                            epochs=3)
    assert tuple(padded._lane_data["epoch_start"].shape) == (3, 3)
    for ses in (shared, stacked, warm, padded):
        assert _asdicts(_drain(ses).results) == _asdicts(one.results)


def test_compact_session_below_its_live_peak_raises(smoke_net):
    """A compact session pinned to a rung below its live peak cannot
    escalate mid-run and raises at `finish`; one started at the rung the
    sweep escalated to equals the one-shot run."""
    sw = _sweep(smoke_net, "compact")
    one = sw.run_lanes([(3.0, 0, None)])
    sw._capacity_floor = 8
    ses = sw.start_lanes([(3.0, 0, None)], window=100)
    assert ses.capacity == 8
    with pytest.raises(RuntimeError, match="cannot re-dispatch"):
        _drain(ses)
    assert one.occupancy_peak > 8
    sw._capacity_floor = 0
    escalated = sw.run_lanes_async([(3.0, 0, None)], capacity=8).finish()
    assert escalated.escalations >= 1
    ses = sw.start_lanes([(3.0, 0, None)], window=100)
    assert ses.capacity == sw._capacity_floor >= one.occupancy_peak
    assert _asdicts(_drain(ses).results) == _asdicts(one.results)


def test_finish_before_the_budget_raises(smoke_net):
    ses = _sweep(smoke_net).start_lanes(LANES, window=100)
    ses.advance()
    with pytest.raises(ValueError, match="advance"):
        ses.finish()
    with pytest.raises(ValueError):
        _sweep(smoke_net).start_lanes(LANES, window=0)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_sim_state_snapshot_round_trip_exact(tmp_path, smoke_net):
    sw = _sweep(smoke_net)
    ses = sw.start_lanes(LANES, window=100)
    ses.advance()
    snap = {"s1": ses.export()}
    path = save_sim_state(str(tmp_path), 3, snap, extra={"round": 3})
    assert path.endswith("step-00000003")
    template = {"s1": sw.start_lanes(LANES, window=100).export()}
    state, extra, step = restore_sim_state(str(tmp_path), template)
    assert step == 3 and extra == {"round": 3}
    got, want = state["s1"], snap["s1"]
    assert int(got["cycle"]) == 100
    np.testing.assert_array_equal(got["keys"], want["keys"])
    for k, v in vars(want["state"]).items():
        if k == "stats":
            continue
        g = getattr(got["state"], k)
        assert g.dtype == v.dtype
        np.testing.assert_array_equal(g, v)
    for k, v in vars(want["state"].stats).items():
        g = getattr(got["state"].stats, k)
        assert g.dtype == v.dtype
        np.testing.assert_array_equal(g, v)
    got["cycle"] = int(got["cycle"])
    resumed = sw.start_lanes(LANES, window=100, restore=got)
    assert _asdicts(_drain(resumed).results) == _asdicts(
        sw.run_lanes(LANES).results)


def test_checkpointer_keeps_the_newest_and_writes_async(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = {"a": torch.arange(4, dtype=torch.int32), "b": [np.ones(2), 7]}
    for step in (1, 2, 3):
        ck.save(step, tree, blocking=step != 3, extra={"s": step})
    ck.wait()
    assert ck.list_steps() == [2, 3] and ck.latest_step() == 3
    assert ck.manifest()["extra"] == {"s": 3}
    got, step = ck.restore(tree)
    assert step == 3 and got["a"].dtype == np.int32
    np.testing.assert_array_equal(got["a"], np.arange(4))
    assert int(got["b"][1]) == 7
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore(tree)


def test_export_is_a_copy_on_the_cpu(smoke_net):
    """A snapshot taken mid-run does not move as the session advances."""
    ses = _sweep(smoke_net).start_lanes(LANES, window=100)
    ses.advance()
    snap = ses.export()
    delivered = snap["state"].stats.delivered.copy()
    b_count = snap["state"].b_count.copy()
    ses.advance()
    np.testing.assert_array_equal(snap["state"].stats.delivered, delivered)
    np.testing.assert_array_equal(snap["state"].b_count, b_count)


def test_bucket_config_is_the_reference_s():
    """A bucket's engine config is the reference's field for field — with
    its seed normalized to 0 and, as in the reference, no reaper park age
    even where the spec's routing has one (smoke_fleet's)."""
    from repro.exp.serve import bucket_cfg as ref_bucket_cfg
    from repro.exp.serve import lower_request as ref_lower
    from repro_torch.exp.serve import bucket_cfg
    ref_units, _ = ref_lower(ref_scenario("smoke_fleet"), 1, "t", 0)
    units, _ = lower_request(get_scenario("smoke_fleet"), 1, "t", 0)
    assert [u.bucket.label for u in units] == [u.bucket.label
                                               for u in ref_units]
    want = dataclasses.asdict(ref_bucket_cfg(ref_units[0].bucket))
    got = dataclasses.asdict(bucket_cfg(units[0].bucket))
    assert got == want
    assert units[0].bucket.routing.reaper.park_age > 0
    assert got["reap_age"] == 0
