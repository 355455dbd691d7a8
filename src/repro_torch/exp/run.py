"""Run an experiment through the port from the command line (port of
`repro.exp.run`, the same flags).

    python -m repro_torch.exp.run --list
    python -m repro_torch.exp.run --scenario smoke
    python -m repro_torch.exp.run --scenario fig11 --fast
    python -m repro_torch.exp.run --scenario fig10a --out BENCH_fig10a.json
    python -m repro_torch.exp.run --spec my_experiment.json

A registered scenario is executed FROM ITS JSON FORM (serialize ->
deserialize -> run), so every CLI invocation also proves the spec
round-trips; `--spec` runs an arbitrary spec file with the same schema
(`ExperimentSpec.to_dict`).  `--fast` / `--full` rebuild the scenario
through its `*_spec(fast=...)` builder (trimmed-CPU vs. paper scale);
without either flag the registered default instance runs unchanged.
Results are written as ``BENCH_<name>.json`` (override with ``--out``)
with a provenance block (git rev, torch and CUDA versions, backend,
device, spec hash) and printed as CSV rows.  ``--jsonl PATH``
additionally emits the per-lane window/result records of the
`repro_torch.exp.serve` schema (`repro_torch.exp.windows`), so batch and
serve artifacts — and the reference's — diff line-for-line.

The run is on CUDA; `main(argv, device="cpu")` runs it on the CPU.
"""
from __future__ import annotations

import argparse
import json
import sys

from . import registry
from . import windows as W
from .provenance import provenance, spec_hash
from .runner import run_experiment
from .spec import ExperimentSpec

_CSV_COLS = ("topology", "pattern", "route_mode", "vc_mode", "fault",
             "offered", "throughput", "latency")


def _fmt(v) -> str:
    return f"{v:.4f}" if isinstance(v, float) else str(v)


def write_jsonl(result, path: str) -> int:
    """Emit an `ExperimentResult` as the serve-schema JSONL stream
    (`windows`): one meta/request header, then per lane the run's FINAL
    window record plus its result record, then a done record.  After the
    meta line the stream is byte for byte the reference CLI's for the
    same spec."""
    spec = result.spec
    n = 0
    with open(path, "w") as f:
        def emit(rec):
            nonlocal n
            f.write(W.dumps(rec) + "\n")
            n += 1
        lanes = sum(len(g.fault_labels) * len(g.rates) * len(g.seeds)
                    for g in result.grids)
        emit(W.meta_record("run", provenance(spec, result.device)))
        emit(W.request_record(request=1, tenant="batch",
                              scenario=spec.name,
                              spec_sha256=spec_hash(spec), lanes=lanes))
        warmup, measure = spec.axes.warmup, spec.axes.measure
        for ci, g in enumerate(result.grids):
            R, S = len(g.rates), len(g.seeds)
            for fi, flabel in enumerate(g.fault_labels):
                for ri, rate in enumerate(g.rates):
                    for si, seed in enumerate(g.seeds):
                        meta = W.lane_meta(
                            scenario=spec.name, tenant="batch",
                            request=1, cell=ci,
                            lane=(fi * R + ri) * S + si,
                            topology=g.topology.label,
                            topo_kind=g.topology.kind,
                            pattern=g.traffic.label,
                            route_mode=g.routing.route_mode,
                            vc_mode=g.routing.vc_mode, fault=flabel,
                            offered=rate, seed=seed)
                        res = g.results[fi][ri][si]
                        emit(W.window_from_result(
                            meta, res, warmup=warmup, measure=measure))
                        emit(W.result_record(meta, res))
        emit(W.done_record(request=1, tenant="batch", scenario=spec.name,
                           lanes=lanes))
    return n


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.exp.run", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--scenario", help="registered scenario name")
    g.add_argument("--spec", help="path to an ExperimentSpec JSON file")
    g.add_argument("--list", action="store_true",
                   help="list registered scenarios and exit")
    ap.add_argument("--out", default=None,
                    help="output JSON path (default BENCH_<name>.json)")
    ap.add_argument("--jsonl", default=None, metavar="PATH",
                    help="also emit per-lane window/result records as "
                         "JSONL (the repro_torch.exp.serve schema)")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress per-grid progress on stderr")
    scale = ap.add_mutually_exclusive_group()
    scale.add_argument("--fast", action="store_true",
                       help="rebuild the scenario at trimmed CPU scale "
                            "through its *_spec(fast=True) builder")
    scale.add_argument("--full", action="store_true",
                       help="rebuild the scenario at paper scale "
                            "(*_spec(fast=False))")
    args = ap.parse_args(argv)

    if args.list:
        for name in registry.list_scenarios():
            spec = registry.get_scenario(name)
            print(f"{name:24s} grids={spec.num_grids:3d} "
                  f"lanes/grid={spec.axes.lanes_per_grid:3d}  {spec.notes}")
        return 0

    fast = True if args.fast else (False if args.full else None)
    if args.scenario:
        # round-trip through JSON: the run below executes the scenario
        # from its serialized form, not the in-memory registry object
        try:
            picked = registry.get_scenario(args.scenario, fast=fast)
        except KeyError as e:
            print(f"ERROR: {e}", file=sys.stderr)
            return 2
        payload = json.dumps(picked.to_dict())
        spec = ExperimentSpec.from_dict(json.loads(payload))
    else:
        if fast is not None:
            print("ERROR: --fast/--full only apply to registered "
                  "scenarios (--scenario)", file=sys.stderr)
            return 2
        with open(args.spec) as f:
            spec = ExperimentSpec.from_dict(json.load(f))

    result = run_experiment(spec, verbose=not args.quiet, device=device)
    rows = result.rows()

    if args.jsonl:
        n = write_jsonl(result, args.jsonl)
        print(f"wrote {args.jsonl} ({n} records)", file=sys.stderr)

    out_path = args.out or f"BENCH_{spec.name}.json"
    with open(out_path, "w") as f:
        json.dump(dict(
            spec=spec.to_dict(),
            provenance=provenance(spec, result.device),
            rows=[{k: v for k, v in r.items() if k != "avg_hops_by_type"}
                  for r in rows],
            compile_counts=result.compile_counts,
            max_compiles_per_grid=result.max_compiles_per_grid,
            wall_s=result.wall_s), f, indent=2)

    print(",".join(_CSV_COLS))
    for r in rows:
        print(",".join(_fmt(r[c]) for c in _CSV_COLS))
    print(f"\nwrote {out_path}  (grids={len(result.grids)}, "
          f"compiles={result.compile_counts}, wall={result.wall_s:.1f}s)",
          file=sys.stderr)
    if result.max_compiles_per_grid > 1:
        print("ERROR: a grid captured more than once", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
