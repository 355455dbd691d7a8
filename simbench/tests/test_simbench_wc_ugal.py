"""The readers of the cell `sl16-wc-ugal-curve`, `global_hops_per_pkt`
and `misroute_ms_per_cycle` (`simbench/span_segment.py`), on the CPU:
each reads nothing where there is nothing to read and the right number
from a synthetic run, and the eager segment runs at the smoke size.
The port against the reference under the cell's traffic is
`tests/test_torch_wc_ugal.py`."""
import json
from pathlib import Path

import pytest
import torch

from simbench import harness, phases, span_segment
from simbench.run import reader

HERE = Path(__file__).resolve().parent
TRAFFIC = json.loads((HERE.parent / "traffic" / "wc-ugal-curve.json")
                     .read_text())


def load(path):
    return json.loads(Path(path).read_text())


def context(device="cpu", jobs=None):
    """A run of the cell's traffic on the smoke network with five
    W-groups (with three, a W-group pair's intermediate has one candidate
    only)."""
    config = load(HERE / "data" / "smoke-g3.json")
    config["topology"] = dict(config["topology"], g=5)
    traffic = dict(TRAFFIC,
                   rates=load(HERE / "data" / "smoke-curve.json")["rates"])
    if jobs is None:
        seeds = harness.lane_seeds(2**31 + 7, 1, traffic["seeds_per_rate"])
        jobs = [harness.Job(1, seeds, 1.0, 0.0, None)]
    return harness.Context(config, traffic, torch.device(device), 1.0,
                           jobs, 2.0, 0, 0, 0, {})


class Result:
    def __init__(self, glob, delivered):
        self.hops_by_type = {"global": glob, "mesh": 7}
        self.delivered_pkts = delivered


def test_global_hops_per_pkt_sums_every_lane_of_every_job():
    read = reader("global_hops_per_pkt")
    jobs = [harness.Job(1, [1], 1.0, 0.0, [[Result(3, 2)], [Result(5, 2)]]),
            harness.Job(2, [2], 1.0, 0.0, [[Result(4, 4)], [Result(0, 0)]])]
    assert read(context(jobs=jobs)) == pytest.approx(12 / 8)
    idle = [harness.Job(1, [1], 1.0, 0.0, [[Result(0, 0)]])]
    assert read(context(jobs=idle)) is None


def test_misroute_segment_runs_on_the_cpu_and_reads_nothing(monkeypatch):
    calls = []
    measure = span_segment.measure
    monkeypatch.setattr(span_segment, "measure",
                        lambda *a: calls.append(measure(*a)) or calls[-1])
    assert reader("misroute_ms_per_cycle")(context()) is None
    out, = calls
    # one range a cycle of the eager segment, no device time on the CPU
    names = phases.PHASES + ("route.misroute",)
    assert out["counts"] == dict.fromkeys(names, out["cycles"])
    assert out["cycles"] > 0 and out["device_s"] == 0


def test_misroute_reader_reads_nothing_without_spans_or_the_range(
        monkeypatch):
    read = reader("misroute_ms_per_cycle")
    monkeypatch.setitem(read.__globals__, "find_spec", lambda name: None)
    monkeypatch.setattr(span_segment, "measure",
                        lambda *a: pytest.fail("ran without spans"))
    assert read(context("cuda")) is None
    monkeypatch.undo()
    # a program whose segment opened no `route.misroute` range
    monkeypatch.setattr(span_segment, "measure", lambda ctx, names: {
        "cycles": 10, "counts": {"route.misroute": 0},
        "device": {"route.misroute": 0.0}, "device_s": 0.05})
    assert read(context("cuda")) is None


def test_misroute_reader_on_a_synthetic_segment(monkeypatch):
    monkeypatch.setattr(span_segment, "measure", lambda ctx, names: {
        "cycles": 10, "counts": {"route.misroute": 10},
        "device": {"route.misroute": 0.002}, "device_s": 0.05})
    assert reader("misroute_ms_per_cycle")(context("cuda")) == \
        pytest.approx(0.2)
