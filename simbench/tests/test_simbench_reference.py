"""The frozen plain reference against the program (`repro_torch`) on the
CPU: every field of every lane equal, on the smoke network and on a few
cycles of one lane of each benchmark configuration at its full size."""
import json
from pathlib import Path

import pytest

from simbench import harness, reference

HERE = Path(__file__).resolve().parent
CONFIGS = HERE.parent / "configs"
TRAFFIC = HERE.parent / "traffic"


def load(path):
    return json.loads(Path(path).read_text())


def program_lanes(config, traffic, seeds):
    """The program's results of one job of the cell, in (rate, seed)
    order, through its public experiment entry."""
    from repro_torch.exp.runner import clear_caches, run_experiment
    from repro_torch.core.engine.sweep import clear_aot_cache
    spec = harness.job_spec(config, traffic, seeds, "test")
    try:
        grid, = run_experiment(spec, device="cpu").grids
    finally:
        clear_caches()
        clear_aot_cache()
    return [res for row in grid.results[0] for res in row]


@pytest.mark.parametrize("step_impl", ["fused", "jnp", "compact"])
@pytest.mark.parametrize("kind", ["switchless", "dragonfly"])
def test_reference_equals_the_program_on_small_networks(kind, step_impl):
    config = load(HERE / "data" / "smoke-g3.json")
    if kind == "dragonfly":
        config["topology"] = {"kind": "dragonfly", "t": 2, "l": 3, "gl": 1,
                              "g": 5}
    traffic = dict(load(HERE / "data" / "smoke-curve.json"),
                   step_impl=step_impl)
    seeds = [5, 2**31 + 9]
    got = program_lanes(config, traffic, seeds)
    want = reference.simulate(
        config, traffic, [(r, s) for r in traffic["rates"] for s in seeds],
        device="cpu")
    assert [vars(g) for g in got] == [vars(w) for w in want]
    assert sum(w.delivered_pkts for w in want) > 0


@pytest.mark.parametrize("name", ["radix16-switchless-g41",
                                  "radix16-dragonfly-g41"])
def test_reference_equals_the_program_at_full_size(name):
    """One lane at the curve's highest load for 10 + 30 cycles."""
    config = dict(load(CONFIGS / f"{name}.json"), warmup=10, measure=30)
    traffic = dict(load(TRAFFIC / "uniform-curve.json"), rates=[1.6])
    got = program_lanes(config, traffic, [2**31 + 77])
    want = reference.simulate(config, traffic, [(1.6, 2**31 + 77)],
                              device="cpu")
    assert [vars(g) for g in got] == [vars(w) for w in want]
    assert want[0].delivered_pkts > 0 and want[0].hops_by_type["global"] > 0
