"""Run one cell of the benchmark that `BENCHMARK.json` describes:

    python3 simbench/run.py --workload sl16-uniform-curve --seed 7 \\
        --seconds 30 --trace 0

from the root of a checkout with the card.  The cell's configuration and
traffic files, and one reader a metric (``simbench/metrics/<name>.py``),
are found by the names in `BENCHMARK.json`.  The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``check``, the numbers compared beside their limits, which also close
standard error.  Without a card, with fewer cards than the cell asks
for, or with JAX or the JAX package loaded once the window has closed,
it prints no result and exits with a code other than 0.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
# every build and kernel cache of the run inside the checkout, at fixed
# paths (the netsim library builds under build/kernels/ by itself)
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "simbench" / sub)
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# a kernel's demangled name is cut to this many characters in `breakdown`
NAME_CHARS = 160


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reader(name: str):
    """The `read(ctx)` of ``simbench/metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    mod_name = "simbench_metric_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, trace: bool) -> dict:
    """name -> (reader, unit) of the metrics this cell's line reports."""
    entries = bench["per_layer" if trace else "end_to_end"]
    return {m["name"]: (reader(m["name"]), m["unit"]) for m in entries
            if cell in m.get("workloads", [cell])}


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"], capture_output=True,
            text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"
    return out.stdout.strip() or f"not read (exit {out.returncode})"


def breakdown(trace) -> dict:
    """The ten device operations that took most time, and the ten longest
    idle gaps of the traced segment, each named by the host operation
    that overlaps it most."""
    by_name: dict = {}
    for name, _, start, end in trace.device_ops:
        by_name[name] = by_name.get(name, 0) + end - start
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    busy = trace.busy_intervals()
    edges = [trace.start_ns] + [x for s, e in busy for x in (s, e)] \
        + [trace.end_ns]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges) - 1, 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:10]
    idle = []
    for length, s, e in gaps:
        overlap: dict = {}
        for name, hs, he in trace.host_ops:
            o = min(e, he) - max(s, hs)
            if o > 0:
                overlap[name] = overlap.get(name, 0) + o
        label = max(overlap, key=overlap.get) if overlap else "no host op"
        idle.append([label, length * 1e-9])
    return {"device_ops": [[n[:NAME_CHARS], ns * 1e-9] for n, ns in ops],
            "idle_gaps": idle}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench = load_json(ROOT / "BENCHMARK.json")
    cell = next((w for w in bench["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    conf_entry = next(c for c in bench["configs"]
                      if c["name"] == cell["config"])
    config = load_json(ROOT / conf_entry["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    readers = cell_metrics(bench, cell["name"], bool(args.trace))

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{cell['name']} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from simbench.harness import run_cell
    out = run_cell(config, traffic, seed=args.seed, seconds=args.seconds,
                   trace=bool(args.trace), device="cuda:0", readers=readers,
                   t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package loaded: {found}",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": out["memory_peak_bytes"],
              "power": power_limit()}
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": out["metrics"],
            "device": device}
    trace = out["trace"]
    if trace is not None:
        device.update(busy_s=trace.busy_s(), window_s=trace.window_s)
        line["breakdown"] = breakdown(trace)
    line["check"] = out["check"]
    print(f"[simbench] {cell['name']} seed {args.seed}: {out['jobs']} jobs "
          f"in {out['window_s']} s, set-up {out['setup_s']} s, "
          f"{device['kind']}, {device['power']}", file=sys.stderr)
    for name, v in out["check"].items():
        print(f"check {name} {v['value']} limit {v['limit']}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
