#!/usr/bin/env python3
"""The dry-run matrix as a markdown table, from the artifacts that
`python -m repro_torch.launch.dryrun` writes.

    python3 tools/dryrun_table.py [DIR]     # default artifacts/dryrun_torch

One row an (arch, shape) with the single-pod (256 ranks) and multi-pod
(512 ranks) cells side by side: status, FLOPs a rank, argument and temp
bytes a rank (GB, 1e9), collective bytes a rank by mesh axis (GB), and
seconds of placement + trace; cells skipped on both meshes are counted
in one line under the table.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def _gb(n) -> str:
    return f"{n / 1e9:.3g}"


def _cell(art) -> str:
    if art is None:
        return "missing"
    if art["status"] != "ok":
        return art["status"]
    mem = art["memory"]
    coll = ", ".join(f"{k} {_gb(v)}" for k, v in
                     sorted(art["collectives"]["by_axis"].items()))
    return (f"{art['flops']:.3e}; {_gb(mem['argument_size_in_bytes'])} / "
            f"{_gb(mem['temp_size_in_bytes'])}; {coll}; "
            f"{art['t_lower_s'] + art['t_compile_s']:.1f} s")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    root = Path(argv[0] if argv else Path(__file__).resolve().parent.parent
                / "artifacts" / "dryrun_torch")
    arts = {}
    for f in sorted(root.glob("*.json")):
        a = json.loads(f.read_text())
        arts[(a["arch"], a["shape"], a["mesh"])] = a
    archs = sorted({k[0] for k in arts})
    print("| arch | shape | single (256): FLOPs; argument / temp GB; "
          "collective GB by axis; s | multi (512): the same |")
    print("| --- | --- | --- | --- |")
    skipped, counts = [], {}
    for arch in archs:
        for shape in SHAPES:
            pair = [arts.get((arch, shape, m)) for m in ("single", "multi")]
            for a in pair:
                st = a["status"] if a else "missing"
                counts[st] = counts.get(st, 0) + 1
            if all(a and a["status"] == "skipped" for a in pair):
                skipped.append(f"{arch} x {shape}")
                continue
            print(f"| {arch} | {shape} | {_cell(pair[0])} | "
                  f"{_cell(pair[1])} |")
    print()
    print(f"Skipped on both meshes ({len(skipped)} pairs): "
          + ", ".join(skipped) + ".")
    print("Cells by status: " + ", ".join(f"{k} {v}" for k, v in
                                          sorted(counts.items())) + ".")
    return 0


if __name__ == "__main__":
    sys.exit(main())
