#!/usr/bin/env python3
"""Time the port's simulator main path on one NVIDIA GPU, for one source
tree.

    python3 tools/sim_timing.py                   # this checkout's src/
    python3 tools/sim_timing.py --src OTHER/src   # another checkout's
    python3 tools/sim_timing.py --label change

Runs `chip_smoke.py` phase 4's sweeps on the paper's radix-16 g = 41
switch-less network (4 lanes, 300 warm-up and 1,200 measured cycles): the
oracle step (`step_impl="jnp"`) at offered 0.1 / 0.4, then the fused and
the compact step at 0.4 / 1.0, seeds 0 and 1, after one untimed 50-cycle
sweep of each step (which builds the kernels and warms the caches).  The
last line is one JSON object: the card (name and power limit from
nvidia-smi), the tree, and per step the wall seconds of the timed sweep
and its cycles/s (cycles, escalation re-runs included, over wall time).

To compare two trees, unpack the other one (`git archive`) into a
directory that .gitignore lists and run this once per tree in turns on
one machine (parent, change, change, parent): each run imports only the
tree it is given, and its kernels build into that tree's build/.  It uses
only entry points that every tree since the fused and compact steps were
ported has: `topology`, `traffic` and `Simulator.sweep_grid`.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

STEPS = (("jnp", (0.1, 0.4)), ("fused", (0.4, 1.0)), ("compact", (0.4, 1.0)))
SEEDS = (0, 1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"),
                    help="the src/ directory of the tree to time")
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    src = Path(args.src).resolve()
    if not (src / "repro_torch").is_dir():
        print(f"sim_timing: no repro_torch package under {src}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        print("sim_timing: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import topology as T
    from repro_torch.core import traffic
    from repro_torch.core.simulator import SimConfig, Simulator
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    net = T.build_switchless(T.paper_radix16_switchless(), "radix16-g41")
    out = {}
    for impl, rates in STEPS:
        for warmup, measure in ((10, 40), (300, 1200)):
            cfg = SimConfig(warmup=warmup, measure=measure, step_impl=impl)
            sim = Simulator(net, cfg, traffic.uniform(net), device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            grid = sim.sweep_grid(list(rates), seeds=SEEDS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        cycles = (warmup + measure) * (1 + getattr(grid, "escalations", 0))
        out[impl] = {"wall_s": wall, "cycles_per_s": cycles / wall}
        print(f"[sim_timing] {args.label} {impl}: {cycles} cycles in "
              f"{wall:.3f} s, {cycles / wall:.2f} cycles/s", flush=True)
    print(json.dumps({"card": card, "label": args.label, "src": str(src),
                      "steps": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
