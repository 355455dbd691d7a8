"""The control of the output check: the plain reference put in the
program's place with each lane's injection probability rounded through
bfloat16, the float below the float32 the simulator states, compared
with the float32 reference by the harness's own comparison.  It has to
come out not correct.

    python3 simbench/control.py --workload sl16-uniform-curve \\
        --seeds 11 12 13 [--device cuda]

For each seed it takes the lanes of the run's first timed job (every
rate x seed slot), runs every seed's lanes together once in each
precision, and prints one JSON line a seed with the numbers compared
beside their limits.  The benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from simbench import check, harness, reference  # noqa: E402


def readings(config: dict, traffic: dict, seeds: list, device) -> list:
    """One (seed, numbers compared) pair a seed."""
    rates = list(traffic["rates"])
    per = [[(r, s) for r in rates for s in
            harness.lane_seeds(seed, 1, traffic["seeds_per_rate"])]
           for seed in seeds]
    lanes = [lane for group in per for lane in group]
    want = reference.simulate(config, traffic, lanes, device=device)
    got = reference.simulate(config, traffic, lanes, device=device,
                             rate_dtype=torch.bfloat16)
    out, i = [], 0
    for seed, group in zip(seeds, per):
        n = len(group)
        out.append((seed, check.compare(got[i:i + n], want[i:i + n])))
        i += n
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads(
        (ROOT / "simbench" / "traffic" / f"{cell['traffic']}.json")
        .read_text())
    t0 = time.perf_counter()
    for seed, numbers in readings(config, traffic, args.seeds,
                                  torch.device(args.device)):
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_correct": check.passes(numbers),
                          "check": numbers}), flush=True)
    print(f"[control] {time.perf_counter() - t0} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
