"""The port's experiment layer (`repro_torch.exp`) against the reference's
(`repro.exp`), on the CPU.

Every registered scenario's spec JSON round-trips between the packages
with an equal `to_dict()` and `spec_hash`; the reference's validation
cases raise `ValueError` in the port too; `cells()` lowers in the same
order with the same labels; `ExperimentResult.rows()` equals the
reference's field for field (all but `wall_s` and `compile_s`, which are
timings); the run CLI's JSONL after its meta line is byte for byte the
reference CLI's; and `run_fleet` gives the reference's quantiles.
Tolerance: exact, as for every simulator counter.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import repro.exp as RX
from repro.core.engine import clear_aot_cache as ref_clear_aot_cache
from repro.exp import fleet as RF
from repro.exp import registry as RR
from repro.exp import run as RRUN
import repro_torch.exp as PX
from repro_torch.exp import fleet as PF
from repro_torch.exp import registry as PR
from repro_torch.exp import run as PRUN
from repro_torch.exp import runner as PRUNNER

torch.set_num_threads(1)

# bench_faults runs 300 + 1,500 cycles in the registry; here 100 + 400,
# so the file stays inside its time (the cut applies to both packages)
BENCH_FAULTS_CUT = dict(warmup=100, measure=400)
ROW_SCENARIOS = ("smoke", "smoke_fused", "smoke_compact", "smoke_faults",
                 "smoke_warm_faults", "bench_faults")
TIMINGS = ("wall_s", "compile_s")


def _port(spec):
    """The reference spec loaded by the port from its JSON."""
    return PX.ExperimentSpec.from_dict(json.loads(json.dumps(spec.to_dict())))


def _fresh_reference():
    """Drop the reference's caches, so its compile counts read as a first
    run (as the port's do on the CPU) and no escalated rung carries over."""
    RX.clear_caches()
    ref_clear_aot_cache()


def test_scenario_names_match_the_reference():
    assert PR.list_scenarios() == RR.list_scenarios()
    assert "smoke_fleet" in PR.list_scenarios()


@pytest.mark.parametrize("name", RR.list_scenarios())
def test_scenario_round_trips_between_packages(name):
    """The registered spec, and its fast/full builds where the scenario
    has a builder, loaded by the port from the reference's JSON, gives the
    reference's dict and hash — and the port's own registry holds the
    same spec."""
    specs = [RR.get_scenario(name)]
    if name in RR._BUILDERS:
        specs += [RR.get_scenario(name, fast=f) for f in (True, False)]
        assert [PR.get_scenario(name, fast=f).to_dict()
                for f in (True, False)] == [s.to_dict() for s in specs[1:]]
    assert PR.get_scenario(name).to_dict() == specs[0].to_dict()
    for ref in specs:
        got = _port(ref)
        assert got.to_dict() == ref.to_dict()
        assert PX.spec_hash(got) == RX.spec_hash(ref)
        assert PX.ExperimentSpec.from_dict(got.to_dict()) == got


def test_smoke_fleet_round_trips_between_packages():
    for fast in (True, False):
        ref = RF.smoke_fleet(fast)
        got = PF.FleetSpec.from_dict(json.loads(json.dumps(ref.to_dict())))
        assert got.to_dict() == ref.to_dict()
        assert PX.spec_hash(got.to_experiment()) == RX.spec_hash(
            ref.to_experiment())


def _minimal(m, **kw):
    base = dict(
        name="t",
        topologies=m.TopologySpec.switchless(a=1, b=1, m=2, n=6, noc=2,
                                             g=1),
        traffics=m.TrafficSpec("uniform"),
        routings=m.RoutingSpec(),
        axes=m.SweepAxes(rates=(0.5,), warmup=10, measure=20))
    base.update(kw)
    return m.ExperimentSpec(**base)


def _future_schema(m):
    d = m.get_scenario("smoke").to_dict()
    d["version"] = 999
    return m.ExperimentSpec.from_dict(d)


# the invalid specs of tests/test_exp.py, each built by either package
INVALID = {
    "topology kind": lambda m: m.TopologySpec("mesh3d"),
    "topology missing fields": lambda m: m.TopologySpec.switchless(a=1),
    "topology g range": lambda m: m.TopologySpec.switchless(
        a=1, b=1, m=2, n=6, noc=2, g=99),
    "unknown preset": lambda m: m.TopologySpec.preset("radix99_switchless"),
    "traffic name": lambda m: m.TrafficSpec("nope"),
    "traffic param": lambda m: m.TrafficSpec(
        "hotspot", params=(("bogus_param", 1),)),
    "route mode": lambda m: m.RoutingSpec(route_mode="teleport"),
    "vc mode": lambda m: m.RoutingSpec(vc_mode="reduced"),
    "updown_merged with val": lambda m: m.RoutingSpec(
        vc_mode="updown_merged", route_mode="val"),
    "buf_pkts 0": lambda m: m.RoutingSpec(buf_pkts=0),
    "grant impl": lambda m: m.RoutingSpec(grant_impl="triton"),
    "step impl": lambda m: m.RoutingSpec(step_impl="vectorized"),
    "negative park age": lambda m: m.ReaperSpec(park_age=-1),
    "fault kind": lambda m: m.FaultSpec(kind="gremlins"),
    "fault frac": lambda m: m.FaultSpec(kind="links", frac=1.5),
    "fault link type": lambda m: m.FaultSpec(kind="links",
                                             types=("optical",)),
    "fault num": lambda m: m.FaultSpec(kind="routers", num=-1),
    "onsets without kind": lambda m: m.FaultSpec(onsets=(100,)),
    "onset at 0": lambda m: m.FaultSpec(kind="links", frac=0.1,
                                        onsets=(0,)),
    "onsets not increasing": lambda m: m.FaultSpec(
        kind="links", frac=0.1, onsets=(50, 50)),
    "repairs without onsets": lambda m: m.FaultSpec(
        kind="links", frac=0.1, repairs=(50,)),
    "repair before last onset": lambda m: m.FaultSpec(
        kind="links", frac=0.1, onsets=(50, 90), repairs=(80,)),
    "onset past the run": lambda m: m.SweepAxes(
        rates=(0.5,), faults=(m.FaultSpec(kind="links", frac=0.1,
                                          onsets=(50, 90)),),
        warmup=10, measure=30),
    "no rates": lambda m: m.SweepAxes(rates=()),
    "no seeds": lambda m: m.SweepAxes(rates=(0.5,), seeds=()),
    "negative rate": lambda m: m.SweepAxes(rates=(-0.1,)),
    "measure 0": lambda m: m.SweepAxes(rates=(0.5,), measure=0),
    "dragonfly with updown": lambda m: _minimal(
        m, topologies=m.TopologySpec.dragonfly(t=4, l=0, gl=0, g=1),
        routings=m.RoutingSpec(vc_mode="updown")),
    "mesh faults under baseline": lambda m: _minimal(m, axes=m.SweepAxes(
        rates=(0.5,), faults=(m.FaultSpec(kind="links", frac=0.05),),
        warmup=10, measure=20)),
    "clusters on dragonfly": lambda m: _minimal(
        m, topologies=m.TopologySpec.dragonfly(t=4, l=0, gl=0, g=1),
        axes=m.SweepAxes(rates=(0.5,),
                         faults=(m.FaultSpec(kind="clusters"),),
                         warmup=10, measure=20)),
    "future schema": _future_schema,
}


@pytest.mark.parametrize("case", sorted(INVALID))
def test_invalid_spec_raises_in_both_packages(case):
    for m in (RX, PX):
        with pytest.raises(ValueError):
            INVALID[case](m)


def test_valid_neighbours_of_the_invalid_specs_construct():
    """The reference's valid controls beside its invalid cases."""
    for m in (RX, PX):
        m.RoutingSpec(vc_mode="updown_merged", route_mode="val_restricted")
        a = m.TrafficSpec("hotspot", params=(("seed", 0), ("num_hot", 4)))
        b = m.TrafficSpec("hotspot", params=(("num_hot", 4), ("seed", 0)))
        assert a == b and hash(a) == hash(b)
        _minimal(m, topologies=m.TopologySpec.switchless(
            a=2, b=2, m=2, n=4, noc=2, g=5), axes=m.SweepAxes(
                rates=(0.5,), faults=(m.FaultSpec(
                    kind="links", frac=0.05, types=("global",)),),
                warmup=10, measure=20))


def test_registry_lookups_and_duplicates():
    assert PR.get_scenario("fig11") == PR.get_scenario("fig11", fast=True)
    with pytest.raises(KeyError):
        PR.get_scenario("smoke", fast=True)      # no builder
    with pytest.raises(KeyError):
        PR.get_scenario("nope")
    spec = PR.get_scenario("smoke")
    with pytest.raises(ValueError):
        PR.register_scenario(spec)
    PR.register_scenario(spec, replace=True)


def _cell_rows(mod, spec):
    return [(c.topology.label, c.routing.label, c.traffic.label,
             c.net.num_channels, c.net.num_chips,
             dataclasses.asdict(c.cfg),
             None if c.pattern.inject_mask is None
             else np.asarray(c.pattern.inject_mask).tolist())
            for c in mod.cells(spec)]


@pytest.mark.parametrize("name", ["fig10cf", "fig14_wgroup", "smoke_faults",
                                  "yield_curve", "smoke_fleet"])
def test_cells_same_order_and_labels(name):
    ref = RR.get_scenario(name)
    assert _cell_rows(PX, _port(ref)) == _cell_rows(RX, ref)


def _rows_spec(name):
    spec = RR.get_scenario(name)
    return spec.with_axes(**BENCH_FAULTS_CUT) if name == "bench_faults" \
        else spec


@pytest.mark.parametrize("name", ROW_SCENARIOS)
def test_rows_equal_the_reference(name):
    spec = _rows_spec(name)
    _fresh_reference()
    ref = RX.run_experiment(spec).rows()
    PX.clear_caches()
    got = PX.run_experiment(_port(spec), device="cpu").rows()
    strip = lambda rows: [{k: v for k, v in r.items() if k not in TIMINGS}
                          for r in rows]
    assert strip(got) == strip(ref)
    assert all(r["placement"] == "single" and r["pad_fraction"] == 0.0
               for r in got)


def test_sweep_cache_is_keyed_by_device():
    PX.clear_caches()
    PX.run_experiment(PX.get_scenario("smoke"), device="cpu")
    keys = list(PRUNNER._SWEEP_CACHE)
    assert keys and all(k[-1] == torch.device("cpu") for k in keys)
    assert all(s.device == torch.device("cpu")
               for s in PRUNNER._SWEEP_CACHE.values())


def _lines(path):
    return path.read_text().splitlines()


def test_run_cli_jsonl_is_the_reference_after_the_meta_line(tmp_path):
    _fresh_reference()
    PX.clear_caches()
    for mod, tag, kw in ((RRUN, "ref", {}), (PRUN, "port",
                                             dict(device="cpu"))):
        rc = mod.main(["--scenario", "smoke", "--quiet",
                       "--out", str(tmp_path / f"{tag}.json"),
                       "--jsonl", str(tmp_path / f"{tag}.jsonl")], **kw)
        assert rc == 0
    ref, got = _lines(tmp_path / "ref.jsonl"), _lines(tmp_path / "port.jsonl")
    assert len(got) == len(ref) > 2
    assert got[1:] == ref[1:]
    meta = json.loads(got[0])
    prov = meta["provenance"]
    assert meta["source"] == "run" and prov["backend"] == "cpu"
    assert prov["torch_version"] == torch.__version__
    assert {"cuda_version", "platform", "device_name", "git_rev",
            "spec_sha256"} <= set(prov)
    out = json.loads((tmp_path / "port.json").read_text())
    ref_out = json.loads((tmp_path / "ref.json").read_text())
    assert out["spec"] == ref_out["spec"]
    assert out["rows"] and [
        {k: v for k, v in r.items() if k not in TIMINGS}
        for r in out["rows"]] == [
        {k: v for k, v in r.items() if k not in TIMINGS}
        for r in ref_out["rows"]]


def test_run_cli_lists_every_reference_scenario(capsys):
    assert PRUN.main(["--list"]) == 0
    listed = [line.split()[0] for line in capsys.readouterr().out
              .splitlines() if line.strip()]
    assert listed == RR.list_scenarios()


def test_run_cli_rejects_unknown_scenario_and_scaled_spec(tmp_path):
    assert PRUN.main(["--scenario", "nope"], device="cpu") == 2
    path = tmp_path / "s.json"
    path.write_text(json.dumps(PR.get_scenario("smoke").to_dict()))
    assert PRUN.main(["--spec", str(path), "--fast"], device="cpu") == 2


def test_run_fleet_gives_the_reference_quantiles():
    _fresh_reference()
    PX.clear_caches()
    ref = RF.run_fleet(RF.smoke_fleet()).records
    got = PF.run_fleet(PF.smoke_fleet(), device="cpu").records
    strip = lambda recs: [{k: v for k, v in r.items() if k != "wall_s"}
                          for r in recs]
    assert len(got) == 3
    assert strip(got) == strip(ref)


def test_fleet_inbox_matches_the_reference(tmp_path):
    ref = RF.fleet_inbox(RF.smoke_fleet(), str(tmp_path / "ref"))
    got = PF.fleet_inbox(PF.smoke_fleet(), str(tmp_path / "port"))
    assert [p.split("/")[-1] for p in got] == [p.split("/")[-1]
                                               for p in ref]
    assert all(open(a).read() == open(b).read() for a, b in zip(got, ref))


def test_provenance_names_the_torch_run():
    spec = PX.get_scenario("smoke")
    prov = PX.provenance(spec, device="cpu")
    assert prov["backend"] == "cpu" and prov["platform"] == "cpu"
    assert prov["torch_version"] == torch.__version__
    assert prov["cuda_version"] == torch.version.cuda
    assert prov["spec_sha256"] == RX.spec_hash(RR.get_scenario("smoke"))
    assert "jax_version" not in prov


def test_roofline_spec_round_trips():
    from repro.exp import RooflineSpec as RRoof
    spec = PX.RooflineSpec(fabric="flat", cg_bw_mult=2)
    assert spec.to_dict() == RRoof(fabric="flat", cg_bw_mult=2).to_dict()
    assert PX.RooflineSpec.from_dict(spec.to_dict()) == spec
    assert spec.build_fabric() is not None
    with pytest.raises(ValueError):
        PX.RooflineSpec(mesh="ring")
