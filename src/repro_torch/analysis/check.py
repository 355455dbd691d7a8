"""`python -m repro_torch.analysis.check` — the port's static verification
CLI (port of `repro.analysis.check`, the same flags plus `--device`).

Runs the analysis passes without simulating a run (the step pass runs
one superstep a cell) and exits nonzero on any unsuppressed error OR
warning:

    python -m repro_torch.analysis.check --all --lint --serve
    python -m repro_torch.analysis.check --scenario fig11
    python -m repro_torch.analysis.check --spec my_scenario.json
    python -m repro_torch.analysis.check --lint
    python -m repro_torch.analysis.check --all --out report.json

`--spec FILE` is the admission test for external specs: a file that
doesn't read or construct fails here as SPEC_INVALID; one that does runs
the spec, compile and capacity passes.  `--all` runs spec, compile and
capacity over every registered scenario plus the step pass.

`--device` names the device the proofs and the step pass run on and the
device the compile pass predicts captures for.  Like every entry point
of the port it defaults to CUDA and raises without it
(`device.resolve_device`); `--lint` alone touches no device.
`main(argv, device=...)` runs in-process (a `device` argument overrides
`--device`).  Exit codes: 0 clean, 1 a gating finding, 2 nothing
selected.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

from . import allowlist as allowlist_mod
from .findings import Report


def repo_root() -> Path:
    """The checkout root: `src/repro_torch/...` two parents up from the
    package when run from a source tree, else the CWD."""
    pkg = Path(__file__).resolve().parents[1]   # .../src/repro_torch
    if pkg.parent.name == "src":
        return pkg.parent.parent
    return Path.cwd()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.check",
        description="Static verification of the PyTorch port and its "
                    "experiment specs (no simulation runs).")
    p.add_argument("--all", action="store_true",
                   help="check every registered scenario (spec, compile "
                        "and capacity passes) and run the step pass")
    p.add_argument("--scenario", action="append", default=[],
                   metavar="NAME", help="check one registered scenario "
                   "(repeatable)")
    p.add_argument("--spec", action="append", default=[], metavar="FILE",
                   help="check a JSON ExperimentSpec file (repeatable)")
    p.add_argument("--lint", action="store_true",
                   help="run the REPRO001-003/005 AST lint over the port")
    p.add_argument("--serve", action="store_true",
                   help="certify the repro_torch.exp.serve one-capture-"
                        "per-bucket promise over the mixed smoke "
                        "submission (servepass)")
    p.add_argument("--pairs", type=int, default=None, metavar="N",
                   help="flow pairs per CDG deadlock proof (default 400)")
    p.add_argument("--out", metavar="FILE",
                   help="write the JSON report here")
    p.add_argument("--allowlist", metavar="FILE",
                   help="extra allowlist entries (RULE path reason)")
    p.add_argument("--root", metavar="DIR",
                   help="repo root to lint (default: auto-detected)")
    p.add_argument("--device", metavar="DEV", default=None,
                   help="device of the proofs, the step pass and the "
                        "capture prediction (default: CUDA; raises "
                        "without it)")
    p.add_argument("--verbose", "-v", action="store_true",
                   help="print info findings (the proof log) too")
    return p


def run(args, device=None) -> Report:
    """Run the selected passes; `device` (else `args.device`, else CUDA)
    is resolved only when a pass other than lint is selected.  The
    CHECK_TIME finding gives the seconds of each pass."""
    report = Report()
    t0 = time.perf_counter()
    seconds: dict = {}

    def timed(name, fn, *a, **kw):
        t = time.perf_counter()
        out = fn(*a, **kw)
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t
        return out

    scenario_names = list(args.scenario)
    if args.all:
        from ..exp.registry import list_scenarios
        scenario_names = list_scenarios()

    if scenario_names or args.spec or args.serve:
        from ..device import resolve_device
        device = resolve_device(device if device is not None
                                else args.device)

    if scenario_names or args.spec:
        from ..exp.registry import get_scenario
        from . import capacitypass, compilepass, specpass
        kw = {} if args.pairs is None else {"n_pairs": args.pairs}
        capacitypass.check_env(report)
        specs = [(get_scenario(n), f"scenario:{n}") for n in scenario_names]
        for path in args.spec:
            spec = specpass.load_spec_file(path, report)
            if spec is not None:
                specs.append((spec, f"spec:{path}"))
        for spec, origin in specs:
            timed("spec", specpass.check_spec, spec, origin, report,
                  device=device, **kw)
            timed("compile", compilepass.check_spec, spec, origin, report,
                  device=device)
            timed("capacity", capacitypass.check_spec, spec, origin,
                  report)
        report.mark_pass("spec")
        report.mark_pass("compile")
        report.mark_pass("capacity")

    if args.all:
        from . import steppass
        timed("step", steppass.run_steppass, report, device=device)
        report.mark_pass("step")

    if args.serve:
        from . import servepass
        timed("serve", servepass.check_submission,
              servepass.SMOKE_SUBMISSION, report)
        report.mark_pass("serve")

    if args.lint:
        from .lint import run_lint
        root = Path(args.root) if args.root else repo_root()
        report.extend(timed("lint", run_lint, root))
        report.mark_pass("lint")

    report.apply_allowlist(allowlist_mod.Allowlist.load(args.allowlist))
    per_pass = ", ".join(f"{k} {v:.2f}s" for k, v in seconds.items())
    report.add("check", "CHECK_TIME", "info", "-",
               f"all passes in {time.perf_counter() - t0:.1f}s"
               + (f" ({per_pass})" if per_pass else ""))
    return report


def main(argv=None, device=None) -> int:
    args = build_parser().parse_args(argv)
    if not (args.all or args.scenario or args.spec or args.lint
            or args.serve):
        build_parser().print_help()
        print("\nnothing selected: pass --all, --lint, --serve, "
              "--scenario, or --spec", file=sys.stderr)
        return 2
    report = run(args, device=device)
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(report.to_json() + "\n")
    print(report.render(verbose=args.verbose))
    return 1 if report.failed else 0


if __name__ == "__main__":
    sys.exit(main())
