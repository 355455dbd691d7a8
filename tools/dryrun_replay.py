#!/usr/bin/env python3
"""What the dry-run's replay of alike local cores saves: one cell traced
twice, with the replay (as `python -m repro_torch.launch.dryrun` runs)
and with every layer's core traced, and whether the two count the same.

    PYTHONPATH=src python3 tools/dryrun_replay.py --arch minicpm-2b \
        --shape prefill_32k [--seq-len 8192] [--mesh 16,16] [--device cpu]

prints one line a run (trace seconds, FLOPs, temp bytes) and exits 1 if
the FLOPs, memory or collectives differ.
"""
from __future__ import annotations

import argparse
import contextlib
import sys

from repro_torch.launch import dryrun as D


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--mesh", default="16,16")
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    kw = dict(mesh_shape=tuple(int(n) for n in args.mesh.split(",")),
              device=args.device, seq_len=args.seq_len)
    arts = {}
    for mode in ("replayed", "traced"):
        if mode == "traced":
            D.LocalCost.replay_local_cores = \
                lambda self: contextlib.nullcontext()
        art = D.lower_cell(args.arch, args.shape, False, **kw)
        arts[mode] = art
        print(f"[replay] {args.arch} x {args.shape} seq {args.seq_len} "
              f"mesh {args.mesh} {mode}: trace {art['t_compile_s']} s, "
              f"flops {art['flops']:.6e}, temp "
              f"{art['memory']['temp_size_in_bytes']} B", flush=True)
    a, b = arts["replayed"], arts["traced"]
    same = all(a[k] == b[k] for k in ("flops", "memory", "collectives"))
    print(f"[replay] counts equal: {same}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
