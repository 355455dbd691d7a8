"""The port (`repro_torch`) against the benchmark's frozen plain
reference (`simbench.reference`, plain PyTorch) under the cell
`sl16-wc-ugal-curve`'s traffic: worst-case W-group traffic under UGAL-G,
NV 12.  Every field of every lane equal, on a small switch-less network
under the fused, oracle and compact steps, and on a few cycles of one
lane of the cell's configuration `radix16-switchless-g41-ugal` (the
paper's network) at its full size; in both, some packets went through
an intermediate W-group.  The configuration file states the shape the
cell builds.

The file imports neither jax nor the reference package `repro`.
"""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from simbench import harness, reference  # noqa: E402

SIMBENCH = ROOT / "simbench"
TRAFFIC = json.loads((SIMBENCH / "traffic" / "wc-ugal-curve.json")
                     .read_text())
CONFIG = SIMBENCH / "configs" / "radix16-switchless-g41-ugal.json"
SEEDS = [5, 2**31 + 9]


def load(path):
    return json.loads(Path(path).read_text())


def small_config():
    """The benchmark tests' smoke network with five W-groups: with three,
    a W-group pair's intermediate has one candidate only."""
    config = load(SIMBENCH / "tests" / "data" / "smoke-g3.json")
    config["topology"] = dict(config["topology"], g=5)
    return config


def small_traffic(step_impl):
    rates = load(SIMBENCH / "tests" / "data" / "smoke-curve.json")["rates"]
    return dict(TRAFFIC, step_impl=step_impl, rates=rates)


def program_lanes(config, traffic, seeds):
    """The port's results of one job of the cell, in (rate, seed) order,
    through its public experiment entry."""
    from repro_torch.core.engine.sweep import clear_aot_cache
    from repro_torch.exp.runner import clear_caches, run_experiment
    spec = harness.job_spec(config, traffic, seeds, "test")
    try:
        grid, = run_experiment(spec, device="cpu").grids
    finally:
        clear_caches()
        clear_aot_cache()
    return [res for row in grid.results[0] for res in row]


def global_and_delivered(results) -> tuple:
    return (sum(r.hops_by_type["global"] for r in results),
            sum(r.delivered_pkts for r in results))


@pytest.fixture(scope="module")
def small_reference():
    traffic = small_traffic("fused")
    return reference.simulate(
        small_config(), traffic,
        [(r, s) for r in traffic["rates"] for s in SEEDS], device="cpu")


@pytest.mark.parametrize("step_impl", ["fused", "jnp", "compact"])
def test_wc_ugal_equals_the_reference_on_a_small_network(small_reference,
                                                         step_impl):
    got = program_lanes(small_config(), small_traffic(step_impl), SEEDS)
    assert [vars(g) for g in got] == [vars(w) for w in small_reference]
    hops, delivered = global_and_delivered(small_reference)
    # some packet went through an intermediate W-group
    assert 0 < delivered < hops


def test_wc_ugal_equals_the_reference_at_full_size():
    """One lane of the cell at its top rate for 10 + 30 cycles: UGAL has
    sent packets non-minimally by then."""
    config = dict(load(CONFIG), warmup=10, measure=30)
    top, seed = TRAFFIC["rates"][-1], 2**31 + 77
    traffic = dict(TRAFFIC, rates=[top])
    got = program_lanes(config, traffic, [seed])
    want = reference.simulate(config, traffic, [(top, seed)], device="cpu")
    assert [vars(g) for g in got] == [vars(w) for w in want]
    hops, delivered = global_and_delivered(want)
    assert 0 < delivered < hops
    # minimal routing of the same lane takes far fewer global hops
    minimal = reference.simulate(config, dict(traffic, route_mode="min"),
                                 [(top, seed)], device="cpu")
    assert global_and_delivered(minimal)[0] < hops


def test_the_cell_config_is_the_paper_network_and_states_its_shape():
    """The cell's configuration runs `radix16-switchless-g41`'s network
    and routers (only the routing around them differs, and the traffic
    file names it), and its `shape` is what the cell builds under UGAL:
    NV 12, 304,384 request rows a lane."""
    from simbench.roofline import cycle_shapes
    config = load(CONFIG)
    uniform = load(SIMBENCH / "configs" / "radix16-switchless-g41.json")
    run_keys = ("topology", "pkt_len", "buf_pkts", "srcq_pkts",
                "vcs_per_class", "vc_mode", "warmup", "measure", "published")
    assert {k: config[k] for k in run_keys} == \
        {k: uniform[k] for k in run_keys}
    bench = load(ROOT / "BENCHMARK.json")
    cell = next(w for w in bench["workloads"]
                if w["name"] == "sl16-wc-ugal-curve")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    assert ROOT / entry["file"] == CONFIG
    assert entry["source"] == config["source"] != uniform["source"]
    shapes = cycle_shapes(config, TRAFFIC, 24)
    shape = config["shape"]
    assert (shape["NV"], shape["request_rows_a_lane"], shape["channels"],
            shape["terminals"]) == (shapes["NV"], shapes["N"], shapes["E"],
                                    shapes["T"]) == (12, 304384, 30176, 5248)
    # the buffer store, [B, E, NV, buf_pkts, 8] int32 at the cell's 24
    # lanes, is past 2**31 bytes
    assert shape["buffer_store_bytes_24_lanes"] == \
        24 * shapes["E"] * shapes["NV"] * config["buf_pkts"] * 8 * 4 > 2**31
