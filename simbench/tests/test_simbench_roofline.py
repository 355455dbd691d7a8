"""The frozen byte counts, evaluated from a cell's shapes, against the
counts `chip_smoke.py` makes of a real call's arguments."""
import json
from pathlib import Path

import pytest

import chip_smoke
from simbench import harness, roofline

HERE = Path(__file__).resolve().parent


@pytest.mark.parametrize("step_impl, wrapper",
                         [("fused", "cycle_core"), ("jnp", "grant")])
def test_bytes_from_shapes_equal_the_real_call(monkeypatch, step_impl,
                                               wrapper):
    from repro_torch.exp.runner import clear_caches, run_experiment
    from repro_torch.core.engine.sweep import clear_aot_cache
    from repro_torch.kernels.netsim import ops
    config = json.loads((HERE / "data" / "smoke-g3.json").read_text())
    traffic = dict(json.loads((HERE / "data" / "smoke-curve.json")
                              .read_text()), step_impl=step_impl)
    calls = []
    real = getattr(ops, wrapper)

    def spy(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    monkeypatch.setattr(ops, wrapper, spy)
    try:
        run_experiment(harness.job_spec(config, traffic, [3, 4], "t"),
                       device="cpu")
    finally:
        clear_caches()
        clear_aot_cache()
    args, kw = calls[0]
    B = len(traffic["rates"]) * 2
    s = roofline.cycle_shapes(config, traffic, B)
    assert tuple(args[0].shape) == (s["B"], s["N"])
    if wrapper == "cycle_core":
        assert chip_smoke.cycle_core_bytes(args, kw) == \
            roofline.cycle_core_bytes(s["B"], s["N"], s["E"])
    else:
        assert chip_smoke.grant_bytes(args) == \
            roofline.grant_bytes(s["B"], s["N"], s["E"])


def test_cell_shapes():
    config = json.loads((HERE.parent / "configs" /
                         "radix16-switchless-g41.json").read_text())
    s = roofline.cycle_shapes(config, {"route_mode": "min"}, 24)
    assert (s["N"], s["E"], s["NV"]) == (204_672, 30_176, 8)
    assert roofline.cycle_core_bytes(24, s["N"], s["E"]) == 53_466_624
