"""The port's analytical model (Eqs. 1-7, Table III, the energy model) and
cost model (`Fabric`, `roofline`) against the reference: exact equality on
the cases of `tests/test_analytical.py` and `tests/test_roofline_model.py`,
plus a deterministic grid over the property tests' parameter ranges.
Both modules are pure Python, so nothing here needs a device."""
import dataclasses
import itertools

import pytest

from repro.core import analytical as A
from repro.core import cost_model as CM
from repro.core import topology as T
from repro_torch.core import analytical as PA
from repro_torch.core import cost_model as PCM
from repro_torch.core import topology as PT


def _plain(x):
    """A value with the dataclasses of either package turned into dicts,
    so results of the two packages compare with ==."""
    if dataclasses.is_dataclass(x):
        return {k: _plain(v) for k, v in dataclasses.asdict(x).items()}
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


# the paper's named configurations, (reference builder, port builder)
NAMED = [
    ("radix16", T.paper_radix16_switchless, PT.paper_radix16_switchless),
    ("radix32", T.paper_radix32_switchless, PT.paper_radix32_switchless),
    ("table3", T.paper_table3_switchless, PT.paper_table3_switchless),
    ("small_1k", lambda: T.SwitchlessParams(a=2, b=4, m=2, n=6),
     lambda: PT.SwitchlessParams(a=2, b=4, m=2, n=6)),
]
# test_eq1_consistency's and test_balanced_family's ranges, sampled on a
# grid instead of by hypothesis
GRID = [dict(a=am, b=bm, m=m, n=nm)
        for m, am, bm, nm in itertools.product((1, 2, 3, 6), (1, 2, 4),
                                               (1, 3, 8), (1, 5, 12))]
GRID += [dict(a=1, b=2 * m * m, m=m, n=3 * m) for m in range(1, 6)]
GRID += [dict(a=2, b=m * m, m=m, n=3 * m) for m in (2, 4)]
# the feasible points only (h >= 1), as the property test returns early
GRID = [kw for kw in GRID if PT.SwitchlessParams(**kw).h >= 1]

SWITCHLESS_FNS = ("total_chiplets", "global_throughput_bound",
                  "is_balanced_config", "local_throughput_bound",
                  "cgroup_throughput_bound", "cgroup_bisection",
                  "switchless_diameter", "switchless_single_wgroup_diameter",
                  "summarize")


def _switchless_values(mod, p):
    out = {name: _plain(getattr(mod, name)(p)) for name in SWITCHLESS_FNS}
    out["latency_ns"] = mod.switchless_diameter(p).latency_ns()
    return out


@pytest.mark.parametrize("name,ref,port", NAMED, ids=[n[0] for n in NAMED])
def test_named_configs_equal_reference(name, ref, port):
    p, q = ref(), port()
    assert _switchless_values(PA, q) == _switchless_values(A, p)


@pytest.mark.parametrize("kw", GRID, ids=lambda kw: "{a}-{b}-{m}-{n}".format(
    **kw))
def test_parameter_grid_equals_reference(kw):
    p, q = T.SwitchlessParams(**kw), PT.SwitchlessParams(**kw)
    assert _switchless_values(PA, q) == _switchless_values(A, p)


def test_case_studies_equal_reference():
    assert _plain(PA.switchless_case()) == _plain(A.switchless_case())
    assert _plain(PA.switchless_case(PT.paper_radix16_switchless())) == \
        _plain(A.switchless_case(T.paper_radix16_switchless()))
    assert _plain(PA.dragonfly_slingshot_case()) == \
        _plain(A.dragonfly_slingshot_case())
    assert _plain(PA.dragonfly_diameter()) == _plain(A.dragonfly_diameter())
    assert PA.dragonfly_diameter().latency_ns() == \
        A.dragonfly_diameter().latency_ns()
    for ref, port in ((T.paper_radix16_dragonfly, PT.paper_radix16_dragonfly),
                      (T.paper_radix32_dragonfly, PT.paper_radix32_dragonfly)):
        assert PA.dragonfly_scale(port()) == A.dragonfly_scale(ref())


def test_constants_and_energy_model_equal_reference():
    assert PA.HOP_LATENCY_NS == A.HOP_LATENCY_NS
    assert PA.HOP_ENERGY_PJ_PER_BIT == A.HOP_ENERGY_PJ_PER_BIT
    for hops in ({"mesh": 14, "local": 2, "global": 1, "term_onchip": 2},
                 {"local": 2, "global": 1, "term_cable": 2},
                 {"mesh": 3.25, "local": 1.5, "global": 0.75},
                 {}):
        assert PA.energy_per_packet_pj_per_bit(hops) == \
            A.energy_per_packet_pj_per_bit(hops)


ROOFLINE_CASES = [
    (1e15, 2e12, {}, 8, 0.0),
    (3.2e16, 4.1e13, {"model": 6e11, "data": 2e11, "pod": 5e10}, 64, 2.5e16),
    (5e14, 9e12, {"data": 1e12, "other": 3e9}, 16, 1e14),
    (0.0, 1e9, {"model": 1e6}, 1, 0.0),
]


@pytest.mark.parametrize("fabric", ["flat", "wafer", "wafer_2x", "none"])
@pytest.mark.parametrize("case", range(len(ROOFLINE_CASES)))
def test_roofline_equals_reference(fabric, case):
    make = {"flat": lambda m: m.flat_ici_fabric(),
            "wafer": lambda m: m.switchless_wafer_fabric(),
            "wafer_2x": lambda m: m.switchless_wafer_fabric(2.0),
            "none": lambda m: None}[fabric]
    flops, hbm, coll, chips, model = ROOFLINE_CASES[case]
    got = PCM.roofline(flops, hbm, coll, chips, make(PCM), model)
    want = CM.roofline(flops, hbm, coll, chips, make(CM), model)
    assert _plain(got) == _plain(want)
    for prop in ("dominant", "step_time_s", "step_time_overlap_s",
                 "useful_flops_frac", "roofline_frac"):
        assert getattr(got, prop) == getattr(want, prop), prop
    if fabric != "none":
        f, g = make(PCM), make(CM)
        assert _plain(f) == _plain(g)
        for axis in ("model", "data", "pod", "other"):
            assert f.collective_seconds(axis, 1e9) == \
                g.collective_seconds(axis, 1e9)


def test_cost_model_constants_equal_reference():
    for name in ("PEAK_FLOPS_BF16", "HBM_BW", "ICI_BW_PER_LINK",
                 "ICI_LINKS_PER_CHIP", "ONWAFER_PORT_BW", "LR_PORT_BW"):
        assert getattr(PCM, name) == getattr(CM, name), name


def test_port_core_exports_the_models():
    import repro_torch.core as core
    assert core.analytical is PA and core.cost_model is PCM
