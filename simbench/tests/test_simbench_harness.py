"""The harness driven on the CPU at the smoke size, past its look for a
card: a sound run is correct; the control (the reference with bfloat16
injection probabilities in the program's place) and each fault planted
in the timed path come out not correct."""
import time
from pathlib import Path

import pytest
import torch

from simbench import control, harness
from simbench.run import cell_metrics, load_json

HERE = Path(__file__).resolve().parent
BENCH = load_json(HERE.parents[1] / "BENCHMARK.json")


def cell(trace=False, device="cpu", **kw):
    config = load_json(HERE / "data" / "smoke-g3.json")
    traffic = load_json(HERE / "data" / "smoke-curve.json")
    return harness.run_cell(
        config, traffic, seed=kw.get("seed", 2**31 + 3), seconds=0.0,
        trace=trace, device=device,
        readers=cell_metrics(BENCH, "sl16-uniform-curve", trace),
        t_start=time.perf_counter())


@pytest.fixture(autouse=True)
def fresh_program():
    """No sweep or graph of another test: a planted fault reaches the
    steps and graphs the run builds."""
    from repro_torch.core.engine.sweep import clear_aot_cache
    from repro_torch.exp.runner import clear_caches
    clear_caches()
    clear_aot_cache()
    yield


def test_sound_run_is_correct():
    out = cell()
    assert out["correct"] and out["failed"] == 0
    assert out["check"] == {"lanes_differing": {"value": 0, "limit": 0},
                            "widest_counter_gap": {"value": 0.0,
                                                   "limit": 0}}
    assert set(out["metrics"]) == {"lane_cycles_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert out["attempted"] == 6 * out["jobs"]


def test_traced_run_reports_the_host_metrics_on_the_cpu():
    out = cell(trace=True)
    assert out["correct"]
    # the device metrics read nothing without a card
    assert set(out["metrics"]) == {"runner_overhead_share",
                                   "captures_in_window"}
    assert out["metrics"]["captures_in_window"]["value"] == 0
    assert out["trace"].cycles == 100


def _state_unchanged(monkeypatch):
    from repro_torch.core.engine import graphs
    monkeypatch.setattr(graphs, "superstep_body",
                        lambda step, K: lambda state, *args: state)


def _half_batch(monkeypatch):
    from repro_torch.core.engine import sweep
    real = sweep._host_stats

    def half(parts):
        stats = real(parts)
        for v in vars(stats).values():
            h = v.shape[0] // 2
            v[h:2 * h] = v[:h]
        return stats

    monkeypatch.setattr(sweep, "_host_stats", half)


def _answer_altered(monkeypatch):
    from repro_torch.core.engine import sweep
    real = sweep._host_stats

    def altered(parts):
        stats = real(parts)
        stats.delivered[0] += 1
        return stats

    monkeypatch.setattr(sweep, "_host_stats", altered)


@pytest.mark.parametrize("plant", [_state_unchanged, _half_batch,
                                   _answer_altered])
def test_a_fault_in_the_timed_path_is_not_correct(monkeypatch, plant):
    plant(monkeypatch)
    out = cell()
    assert not out["correct"]
    assert out["check"]["lanes_differing"]["value"] > 0


@pytest.mark.parametrize("seed", [11, 12, 2**31 + 13])
def test_the_control_is_not_correct(seed):
    config = load_json(HERE / "data" / "smoke-g3.json")
    traffic = load_json(HERE / "data" / "smoke-curve.json")
    (s, numbers), = control.readings(config, traffic, [seed], "cpu")
    assert s == seed and numbers["lanes_differing"]["value"] > 0
    assert not harness.check_mod.passes(numbers)


def test_lane_seeds_and_the_sample():
    a = harness.lane_seeds(2**31 + 5, 1, 3)
    b = harness.lane_seeds(2**31 + 5, 2, 3)
    assert a == harness.lane_seeds(2**31 + 5, 1, 3)
    assert a[0] == b[0] and a[1:] != b[1:] and len(a) == 3
    jobs = [harness.Job(i, harness.lane_seeds(9, i, 3), 1.0, 0.0, None)
            for i in (1, 2, 3)]
    sample = harness.check_sample(9, jobs, [0.2, 0.4])
    assert sorted((ri, si) for _, ri, si in sample) == \
        [(r, s) for r in range(2) for s in range(3)]


def test_run_prints_no_result_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("the card is there")
    from simbench import run
    assert run.main(["--workload", "sl16-uniform-curve", "--seed", "1",
                     "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_unknown_traffic_keys_are_refused():
    with pytest.raises(ValueError, match="faults"):
        harness.check_traffic({"pattern": "uniform", "faults": []})


@pytest.mark.cuda
def test_sound_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = cell(trace=True, device="cuda")
    assert out["correct"]
    assert out["metrics"]["kernels_per_cycle"]["value"] > 0
    assert 0 < out["metrics"]["cycle_core_roofline"]["value"] < 100
    assert 0 <= out["metrics"]["idle_share"]["value"] < 100
