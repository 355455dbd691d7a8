"""The readers of the program's spans: `key_chain_share`,
`replay_gap_ms_per_cycle` and the four phase metrics
(`simbench/phases.py`).  Each reads nothing without a card, a trace or
the program's spans, and the right number from a synthetic run; the
eager phase segment and the key chain's job run on the CPU at the smoke
size."""
from pathlib import Path

import pytest
import torch

from simbench import harness, phases
from simbench.run import load_json, reader

HERE = Path(__file__).resolve().parent
PHASE_METRICS = ["inject_ms_per_cycle", "requests_ms_per_cycle",
                 "grant_ms_per_cycle", "commit_ms_per_cycle"]


def context(device="cpu", trace=None):
    config = load_json(HERE / "data" / "smoke-g3.json")
    traffic = load_json(HERE / "data" / "smoke-curve.json")
    seeds = harness.lane_seeds(2**31 + 7, 1, traffic["seeds_per_rate"])
    job = harness.Job(1, seeds, 1.0, 0.0, None)
    return harness.Context(config, traffic, torch.device(device), 1.0,
                           [job], 2.0, 0, 0, 0, {}, trace=trace)


def trace(host_ops, device_ops, cycles=2):
    return harness.Trace(0, 1000, cycles,
                         [(f"k{i}", "kernel", s, e)
                          for i, (s, e) in enumerate(device_ops)], host_ops)


def test_replay_gap_reads_nothing_without_a_trace_or_its_span():
    read = reader("replay_gap_ms_per_cycle")
    assert read(context()) is None
    assert read(context(trace=trace([("aten::add", 0, 50)],
                                    [(0, 10)]))) is None


def test_replay_gap_on_a_synthetic_trace():
    read = reader("replay_gap_ms_per_cycle")
    # the key chain until 200 ns (the device idle), the replays issued
    # from 200 to 300 ns while the device runs to 800 ns with two gaps
    # (300-350, 500-600) and an idle tail after the last operation
    host = [("sweep.key_chain", 0, 200), ("graph.replays", 200, 300),
            ("graph.copy", 300, 320)]
    dev = [(0, 20), (210, 300), (350, 500), (600, 800)]
    got = read(context(trace=trace(host, dev)))
    # idle inside [200, 800]: 200-210, 300-350 and 500-600 = 160 ns
    assert got == pytest.approx(160e-6 / 2)


def test_key_chain_share_reads_nothing_without_a_card_or_spans(
        monkeypatch):
    read = reader("key_chain_share")
    assert read(context()) is None
    monkeypatch.setitem(read.__globals__, "find_spec", lambda name: None)
    monkeypatch.setitem(read.__globals__, "rerun_last_job",
                        lambda ctx: pytest.fail("ran without spans"))
    assert read(context("cuda")) is None


def test_key_chain_share_on_a_synthetic_job(monkeypatch):
    read = reader("key_chain_share")
    monkeypatch.setitem(read.__globals__, "rerun_last_job",
                        lambda ctx: (0.5, 2.0))
    assert read(context("cuda")) == pytest.approx(25.0)


def test_key_chain_job_runs_on_the_cpu():
    read = reader("key_chain_share")
    chain_s, wall_s = read.__globals__["rerun_last_job"](context())
    assert 0 < chain_s < wall_s


def test_phase_segment_runs_on_the_cpu_and_its_readers_read_nothing(
        monkeypatch):
    calls = []
    measure = phases.measure
    monkeypatch.setattr(phases, "measure",
                        lambda *a: calls.append(a) or measure(*a))
    ctx = context()
    assert [reader(m)(ctx) for m in PHASE_METRICS] == [None] * 4
    # one segment a run, whichever reader asks first
    assert len(calls) == 1
    out = phases.split(ctx)
    assert out["cycles"] == phases.PHASE_CYCLES
    assert set(out["phases"]) == set(phases.PHASES)
    assert out["device_s"] == 0 and out["seconds"] > 0


def test_phase_readers_read_nothing_without_spans(monkeypatch):
    monkeypatch.setattr(phases, "find_spec", lambda name: None)
    monkeypatch.setattr(phases, "measure",
                        lambda *a: pytest.fail("ran without spans"))
    ctx = context("cuda")
    assert [reader(m)(ctx) for m in PHASE_METRICS] == [None] * 4


def test_phase_readers_on_a_synthetic_split(monkeypatch):
    split = {"cycles": 10, "device_s": 0.05, "seconds": 1.0,
             "phases": {"step.inject": 0.01, "step.requests": 0.02,
                        "step.grant": 0.004, "step.commit": 0.012}}
    monkeypatch.setattr(phases, "measure", lambda *a: split)
    ctx = context("cuda")
    got = [reader(m)(ctx) for m in PHASE_METRICS]
    assert got == pytest.approx([1.0, 2.0, 0.4, 1.2])
