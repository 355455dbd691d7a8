"""The port's static analysis (`repro_torch.analysis`) against the
reference's (`repro.analysis`), on the CPU.

- Parity: the spec, compile and capacity passes over every registered
  scenario, and the serve pass over the smoke submission, give equal
  `(pass, rule, severity, location)` multisets in both packages, and
  equal integers in the messages that count something (VC classes,
  epochs, edges, shared proofs, grids, signatures, rungs, lanes,
  buckets).  CHECK_TIME is a timing and is left out.  Tolerance: exact.
- The predictions hold against what the port builds: the compile pass's
  graphs equal the `graphs.builds()` delta of `run_experiment`, the serve
  pass's graphs the builds of a `SimService` run.
- Each rule fires on a fixture: the reference's spec fixtures, injected
  steps and route kernels, and a lint tree written from strings here.
- The port's tree and `chip_smoke.py` lint clean; the CLI's exit codes,
  its JSON report and its device rule.

The reference modules are imported inside the tests that use them, so
the card-only case runs where JAX is not installed
(``pytest --noconftest -m cuda tests/test_torch_analysis.py``).
"""
import collections
import dataclasses
import json
import re
from pathlib import Path

import pytest
torch = pytest.importorskip("torch")

from repro_torch.analysis import Allowlist, Report
from repro_torch.analysis import capacitypass as PK
from repro_torch.analysis import compilepass as PC
from repro_torch.analysis import servepass as PSV
from repro_torch.analysis import specpass as PS
from repro_torch.analysis import steppass as PST
from repro_torch.analysis.check import main, repo_root
from repro_torch.analysis.lint import LINT_FILES, run_lint
from repro_torch.core.engine import graphs
from repro_torch.exp import registry as PR
from repro_torch.exp import runner as PRUNNER

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures" / "analysis"
# rules whose message integers must agree, and how many leading integers
# (None: all of them); the port's COMPILE_SIG and SERVE_BUCKET messages
# carry its own graph counts after the reference's numbers
COUNTED = {"SPEC_VC": None, "SPEC_CDG": None, "SPEC_REPAIR": None,
           "COMPILE_SIG": 2, "SERVE_BUCKET": 4}
CAPTURE_SCENARIOS = ("smoke", "smoke_fused", "smoke_compact",
                     "smoke_warm_faults")


def _key(f):
    return (f.pass_name, f.rule, f.severity, f.location)


def _ints(f):
    n = COUNTED.get(f.rule, None if f.rule.startswith("CAP_") else 0)
    found = re.findall(r"\d+", f.message)
    return found if n is None else found[:n]


def _assert_parity(ref, port):
    ref = [f for f in ref.findings if f.rule != "CHECK_TIME"]
    port = [f for f in port.findings if f.rule != "CHECK_TIME"]
    assert (collections.Counter(map(_key, ref))
            == collections.Counter(map(_key, port)))
    for r, p in zip(sorted(ref, key=_key), sorted(port, key=_key)):
        assert _ints(r) == _ints(p), (r.message, p.message)


def _graphs_made(report, rule, pattern):
    [f] = [f for f in report.findings if f.rule == rule]
    return int(re.search(pattern, f.message).group(1))


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", PR.list_scenarios())
def test_spec_compile_capacity_match_the_reference(name):
    from repro.analysis import Report as RefReport
    from repro.analysis import capacitypass as RK
    from repro.analysis import compilepass as RC
    from repro.analysis import specpass as RS
    from repro.exp.registry import list_scenarios
    assert name in list_scenarios()
    # each case proves from empty memos, so the shared-proof counts are
    # this scenario's own in both packages
    RS._PROOF_CACHE.clear()
    PS._PROOF_CACHE.clear()
    ref, port = RefReport(), Report()
    RS.check_scenario(name, ref)
    RC.check_scenario(name, ref)
    RK.check_scenario(name, ref)
    PS.check_scenario(name, port, device="cpu")
    PC.check_scenario(name, port, device="cpu")
    PK.check_scenario(name, port)
    _assert_parity(ref, port)
    assert not port.failed, port.render()
    assert {f.rule for f in port.findings} >= {"SPEC_VC", "SPEC_CDG",
                                               "COMPILE_SIG"}


def test_serve_pass_matches_the_reference():
    from repro.analysis import Report as RefReport
    from repro.analysis import servepass as RSV
    assert RSV.SMOKE_SUBMISSION == PSV.SMOKE_SUBMISSION
    ref, port = RefReport(), Report()
    RSV.check_submission(RSV.SMOKE_SUBMISSION, ref)
    PSV.check_submission(PSV.SMOKE_SUBMISSION, port)
    _assert_parity(ref, port)
    assert not port.failed, port.render()


@pytest.mark.parametrize("package", ["reference", "port"])
def test_spec_fixtures_flag_in_both_packages(package):
    if package == "reference":
        from repro.analysis import Report as R
        from repro.analysis.specpass import check_spec_file
        kw = {}
    else:
        R, check_spec_file, kw = Report, PS.check_spec_file, dict(
            device="cpu")
    over = R()
    check_spec_file(str(FIXTURES / "overflow_spec.json"), over, **kw)
    assert over.failed
    assert any(f.rule == "SPEC_GRANT_OVERFLOW" and f.severity == "warning"
               for f in over.gating)
    strand = R()
    check_spec_file(str(FIXTURES / "stranding_spec.json"), strand, **kw)
    [f] = strand.gating
    assert f.rule == "SPEC_INVALID" and "never activate" in f.message


def test_unreadable_spec_file_is_invalid(tmp_path):
    p = tmp_path / "broken.json"
    p.write_text("{not json")
    report = Report()
    PS.check_spec_file(str(p), report, device="cpu")
    assert [f.rule for f in report.gating] == ["SPEC_INVALID"]


# ---------------------------------------------------------------------------
# predicted graphs == graphs the port builds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CAPTURE_SCENARIOS)
def test_compile_prediction_equals_the_runner_s_builds(name):
    """The graphs the compile pass predicts are the runner's: as many, and
    each grid's key built on `meta` (K, lane count, state signature, lane
    signature) is the key `graphs.graph_for` cached for its cell."""
    spec = PR.get_scenario(name)
    report = Report()
    PC.check_spec(spec, f"scenario:{name}", report, device="cpu")
    predicted = _graphs_made(report, "COMPILE_SIG", r"makes (\d+) graph")
    PRUNNER.clear_caches()
    graphs.clear()
    before = graphs.builds()
    result = PRUNNER.run_experiment(spec, device="cpu")
    assert graphs.builds() - before == predicted == spec.num_grids
    assert not any(g.escalations for g in result.grids)
    # graph_for's key: (step, K, lane count, state sig, lane sig, device)
    real = collections.Counter(k[1:5] for k in graphs._GRAPHS)
    model = collections.Counter(
        PC.grid_key(t, r, f, spec.axes, "cpu") for t in spec.topologies
        for r in spec.routings for f in spec.traffics)
    assert real == model


def _wide_spec():
    """`smoke` widened past `graphs.GRAPHS_KEPT`: 3 topology labels x 4
    traffics = 12 cells, cycles cut to 10 + 20."""
    from repro_torch.exp.spec import TrafficSpec
    spec = PR.get_scenario("smoke").with_axes(warmup=10, measure=20)
    topo = spec.topologies[0]
    return dataclasses.replace(
        spec,
        topologies=tuple(dataclasses.replace(topo, label=f"{topo.label}-{i}")
                         for i in range(3)),
        traffics=tuple(TrafficSpec(p) for p in (
            "uniform", "bit_reverse", "bit_shuffle", "bit_transpose")))


def test_compile_prediction_past_the_kept_graphs():
    """More cells than `graphs.GRAPHS_KEPT`: still one graph a cell.  On
    the CPU a graph is built when its cell runs, not when it is prepared,
    so this case holds with or without the runner's chunks of
    `GRAPHS_KEPT` cells; the `cuda` case below is the one that guards
    them."""
    spec = _wide_spec()
    assert spec.num_grids > graphs.GRAPHS_KEPT
    report = Report()
    PC.check_spec(spec, "spec:wide", report, device="cpu")
    assert _graphs_made(report, "COMPILE_SIG",
                        r"makes (\d+) graph") == spec.num_grids
    PRUNNER.clear_caches()
    graphs.clear()
    before = graphs.builds()
    result = PRUNNER.run_experiment(spec, device="cpu")
    assert graphs.builds() - before == spec.num_grids
    assert result.compile_counts == [1] * spec.num_grids


def test_serve_prediction_equals_the_service_s_builds():
    from repro_torch.exp.serve import SimService
    report = Report()
    PSV.check_submission(PSV.SMOKE_SUBMISSION, report)
    predicted = _graphs_made(report, "SERVE_BUCKET",
                             r"sessions make (\d+) graph")
    graphs.clear()
    before = graphs.builds()
    svc = SimService(device="cpu")
    for name in PSV.SMOKE_SUBMISSION:
        svc.submit(PR.get_scenario(name))
    svc.run()
    svc.close()
    assert svc.idle
    assert graphs.builds() - before == predicted == 3


def test_serve_signature_sees_epoch_mismatch():
    """A bucket key whose pinned epoch count disagrees with the lanes'
    real schedules changes the graph key — the defect SERVE_SIG exists to
    catch (the reference's test, on the port)."""
    from dataclasses import replace
    from repro_torch.exp.serve.scheduler import lower_request
    units, _ = lower_request(PR.get_scenario("smoke_warm_faults"), 1, "t", 0)
    key = units[0].bucket
    assert key.epochs >= 2
    real = [u.fset for u in units]
    good = PSV.pack_signature(key, real, pack=8)
    assert good == PSV.pack_signature(key, PSV._canonical_fsets(key), pack=8)
    bad_key = replace(key, epochs=1)
    assert (PSV.pack_signature(bad_key, real, pack=8)
            != PSV.pack_signature(bad_key, PSV._canonical_fsets(bad_key),
                                  pack=8))


def test_serve_window_tail_adds_a_graph(monkeypatch):
    """At K = 4 a window whose last length is not a multiple of K makes a
    K = 1 tail graph too, as `start_lanes` does."""
    monkeypatch.setenv("REPRO_SUPERSTEP", "4")
    assert PSV.session_graphs(100, 250) == (4, 1)
    assert PSV.session_graphs(100, 300) == (4,)
    monkeypatch.setenv("REPRO_SUPERSTEP", "1")
    assert PSV.session_graphs(100, 250) == (1,)


# ---------------------------------------------------------------------------
# step pass
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step_impl", PST.STEP_IMPLS)
def test_step_pass_cell_clean(step_impl):
    report = Report()
    rec = PST.check_cell(report, step_impl, "updown", "warm", device="cpu")
    assert not report.failed, report.render()
    [f] = report.findings
    assert f.rule == "STEP_TRACE" and f.severity == "info"
    assert rec["fields_in"] == rec["fields_out"]
    assert rec["ops"] > 100
    assert not any(rec["launches"].values())     # plain versions on the CPU


def test_non_batch_pure_kernel_flagged():
    """A kernel that couples packets through a cumsum fails the probe."""
    net = PST.TRACE_TOPO.build()
    from repro_torch.core.routing.pipeline import make_pipeline
    real = make_pipeline(net, "baseline", device="cpu").kernel

    def coupled(fl, cur, dest, mis, meta):
        out_ch, req_vc, meta2 = real(fl, cur, dest, mis, meta)
        return out_ch, req_vc + torch.cumsum(torch.ones_like(req_vc),
                                             -1) - 1, meta2

    report = Report()
    PST.check_kernel_batch_purity(report, net, "baseline", kernel=coupled,
                                  device="cpu")
    assert any(f.rule == "STEP_BATCH" and f.severity == "error"
               for f in report.gating)
    clean = Report()
    PST.check_kernel_batch_purity(clean, net, "baseline", device="cpu")
    assert not clean.failed


def _widen(state):
    return state.replace(ch_busy=state.ch_busy.long())


def _reshape(state):
    return state.replace(stats=state.stats.replace(
        hops=state.stats.hops[:, :-1]))


@pytest.mark.parametrize("change,field,rules", [
    (_widen, "ch_busy", {"STEP_CARRY", "STEP_DTYPE"}),
    (_reshape, "stats.hops", {"STEP_CARRY"})])
def test_step_carry_flags_a_changed_field(change, field, rules):
    def wrap(step):
        def changed(state, args):
            out, aux = step(state, args)
            return change(out), aux
        return changed

    report = Report()
    PST.check_cell(report, "fused", "baseline", "pristine", device="cpu",
                   wrap=wrap)
    assert {f.rule for f in report.gating} == rules
    [carry] = [f for f in report.gating if f.rule == "STEP_CARRY"]
    assert field in carry.message


# ---------------------------------------------------------------------------
# lint
# ---------------------------------------------------------------------------

BAD_STEP = '''\
import os
import torch

def step(state, x, ch_type):
    n = x.sum().item()
    k = int(x.max())
    m = bool(torch.any(x))
    if torch.all(x > 0):
        pass
    while (x > 0).any():
        break
    host = x.cpu()
    rows = x.tolist()
    if ch_type == 2:
        pass
    return os.environ.get("REPRO_X")
'''
GOOD_STEP = '''\
import numpy as np
import torch

def step(state, x, lanes, cfg, device):
    b = int(x.shape[0])
    p = max(int(l["epoch_start"].shape[0]) for l in lanes)
    q = int(x.size(1)) + int(x.dim()) + int(x.numel()) + int(len(lanes))
    r = float(np.mean([1.0, 2.0]))
    if torch.device(device).type == "cpu" and torch.cuda.is_available():
        pass
    return torch.where(x > 0, x, 0)

def finalize(stats):
    return int(stats.delivered.sum()), stats.hops.cpu()

def _host(v):
    return v.cpu().numpy()

class Pending:
    def finish(self):
        return int(self.stats.occ_peak.max())
'''
BAD_ENV = 'import os\nX = os.getenv("REPRO_SERVE_PACK")\n'
BAD_SMOKE = 'import jax\nfrom repro.core import topology\n'


def _lint_tree(root: Path) -> list:
    files = {
        "src/repro_torch/__init__.py": 'import os\nV = os.environ["A"]\n',
        "src/repro_torch/core/engine/bad_step.py": BAD_STEP,
        "src/repro_torch/core/engine/good_step.py": GOOD_STEP,
        "src/repro_torch/exp/serve/bad_env.py": BAD_ENV,
        "src/repro_torch/models/broken.py": "def f(:\n",
        "chip_smoke.py": BAD_SMOKE,
    }
    for rel, text in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)
    return run_lint(root)


def test_lint_fixture_trips_every_port_rule(tmp_path):
    findings = _lint_tree(tmp_path)
    errors = [f for f in findings if f.severity == "error"]
    rules = collections.Counter(f.rule for f in errors)
    assert set(rules) == {"REPRO000", "REPRO001", "REPRO002", "REPRO003",
                          "REPRO005"}
    where = lambda rule: {f.location for f in errors if f.rule == rule}
    # every host sync of the bad step, one finding each
    lines = sorted(int(loc.rsplit(":", 1)[1]) for loc in where("REPRO003"))
    assert lines == [5, 6, 7, 8, 10, 12, 13]
    assert all("bad_step.py" in loc for loc in where("REPRO003"))
    # the env reads outside the one module, and not inside it
    assert {loc.rsplit(":", 1)[0] for loc in where("REPRO002")} == {
        "src/repro_torch/core/engine/bad_step.py",
        "src/repro_torch/exp/serve/bad_env.py"}
    assert where("REPRO005") == {"chip_smoke.py:1", "chip_smoke.py:2"}
    assert where("REPRO001") == {"src/repro_torch/core/engine/bad_step.py:14"}
    assert not any("good_step" in f.location for f in errors)


def test_port_and_chip_smoke_lint_clean():
    report = Report()
    findings = run_lint(repo_root())
    report.extend(findings)
    report.apply_allowlist(Allowlist())
    assert not report.failed, report.render()
    assert not any(f.suppressed for f in report.findings)
    [cov] = [f for f in findings if f.rule == "LINT_COVERAGE"]
    n = int(re.search(r"linted (\d+) files", cov.message).group(1))
    assert all((ROOT / name).is_file() for name in LINT_FILES)
    assert n == (len(list((ROOT / "src" / "repro_torch").rglob("*.py")))
                 + len(LINT_FILES))


def test_lint_covers_the_port_examples_only(tmp_path):
    """REPRO004 and REPRO005 on the port's example scripts; the
    reference's scripts beside them are not linted, and REPRO004 is
    about scripts, not the package."""
    hack = 'import sys\nsys.path.insert(0, "src")\nfrom repro import exp\n'
    files = {"examples/torch_serve_lm.py": hack,
             "examples/serve_lm.py": hack,
             "examples/torch_train_lm.py": "import torch\n",
             "src/repro_torch/launch/hack.py": hack.replace("repro ",
                                                            "os ")}
    for rel, text in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)
    errors = [f for f in run_lint(tmp_path) if f.severity == "error"]
    assert {(f.rule, f.location) for f in errors} == {
        ("REPRO004", "examples/torch_serve_lm.py:2"),
        ("REPRO005", "examples/torch_serve_lm.py:3")}


# ---------------------------------------------------------------------------
# CLI and report
# ---------------------------------------------------------------------------

def test_cli_exit_codes_and_json_report(tmp_path):
    out = tmp_path / "report.json"
    rc = main(["--spec", str(FIXTURES / "overflow_spec.json"),
               "--out", str(out)], device="cpu")
    assert rc == 1
    d = json.loads(out.read_text())
    assert d["failed"] and d["passes_run"] == ["spec", "compile", "capacity"]
    back = Report.from_dict(d)
    assert back.to_dict() == d
    assert main(["--scenario", "smoke", "--serve", "--device", "cpu"]) == 0
    assert main([]) == 2


def test_cli_needs_a_device_except_for_lint(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--scenario", "smoke"])
    assert main(["--lint"]) == 0


def test_allowlist_file_suppresses_and_keeps_the_finding(tmp_path):
    bad = tmp_path / "src" / "repro_torch" / "exp" / "bad_env.py"
    bad.parent.mkdir(parents=True)
    bad.write_text(BAD_ENV)
    assert main(["--lint", "--root", str(tmp_path)]) == 1
    allow = tmp_path / "allow.txt"
    allow.write_text("# waiver\nREPRO002 exp/bad_env.py accepted for this "
                     "test\n")
    out = tmp_path / "report.json"
    assert main(["--lint", "--root", str(tmp_path), "--allowlist",
                 str(allow), "--out", str(out)]) == 0
    [f] = [f for f in json.loads(out.read_text())["findings"]
           if f["rule"] == "REPRO002"]
    assert f["suppressed"] and f["suppress_reason"] == "accepted for this test"
    broken = tmp_path / "broken.txt"
    broken.write_text("REPRO001 only-two-fields\n")
    with pytest.raises(ValueError):
        Allowlist.load(str(broken))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_runner_captures_once_a_cell_past_the_kept_graphs():
    """On the card the runner captures a chunk's cells before it runs
    any of them; the chunks hold at most `graphs.GRAPHS_KEPT` cells, so
    none is evicted before it runs and a spec with more cells than that
    still captures once a cell."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    from repro_torch.core.engine import sweep as SW
    spec = _wide_spec()
    report = Report()
    PC.check_spec(spec, "spec:wide", report, device="cuda")
    predicted = _graphs_made(report, "COMPILE_SIG", r"makes (\d+) graph")
    PRUNNER.clear_caches()
    SW.clear_aot_cache()
    before = SW.compile_counter()
    result = PRUNNER.run_experiment(spec, device="cuda")
    assert SW.compile_counter() - before == predicted == spec.num_grids
    assert result.compile_counts == [1] * spec.num_grids


@pytest.mark.cuda
def test_step_pass_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the netsim kernels run only there")
    from repro_torch.kernels.netsim import ops
    card, cpu = Report(), Report()
    d0 = ops.device_launches()
    PST.run_steppass(card, device="cuda")
    d1 = ops.device_launches()
    PST.run_steppass(cpu, device="cpu")
    assert ([(f.rule, f.severity, f.location) for f in card.findings]
            == [(f.rule, f.severity, f.location) for f in cpu.findings])
    assert not card.failed, card.render()
    n = len(PST.VC_MODES) * len(PST.FAULT_KINDS)
    got = {w: {k: d1[w][k] - d0[w][k] for k in d1[w]} for w in d1}
    # each of the 3n cells draws three times in its cycle (min routing,
    # uniform traffic): the split of its key, the coins, the destinations
    assert got == {"grant": {"coop": n, "three_pass": 0},
                   "cycle_core": {"coop": n, "three_pass": n},
                   "head_records": {"dense": n, "picked": n},
                   "threefry": {"split": 3 * n, "bits": 0,
                                "uniform": 3 * n, "randint": 3 * n,
                                "bernoulli": 0}}


@pytest.mark.cuda
@pytest.mark.parametrize("step_impl", PST.STEP_IMPLS)
def test_step_cells_on_the_card_equal_the_cpu(step_impl):
    """Each step-pass cell run for its whole warmup + measure on the card
    (the netsim kernels) and on the CPU (their plain versions): every
    state leaf bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the netsim kernels run only there")
    for vc_mode in PST.VC_MODES:
        for fault_kind in PST.FAULT_KINDS:
            card, cpu = (PST.run_cell(step_impl, vc_mode, fault_kind, dev,
                                      cycles=PST.CELL_CYCLES)["out"]
                         for dev in ("cuda", "cpu"))
            got, want = graphs._leaves(card), graphs._leaves(cpu)
            assert got.keys() == want.keys()
            for k, v in got.items():
                assert v.dtype == want[k].dtype, (vc_mode, fault_kind, k)
                assert torch.equal(v.cpu(), want[k]), (vc_mode, fault_kind,
                                                       k)
