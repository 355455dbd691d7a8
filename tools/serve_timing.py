#!/usr/bin/env python3
"""Time the port's LM serving path on one NVIDIA GPU over several samples,
for one source tree.

    python3 tools/serve_timing.py                   # this checkout's src/
    python3 tools/serve_timing.py --src OTHER/src   # another checkout's
    python3 tools/serve_timing.py --samples 7 --label change

Each served model of `chip_smoke.py` phase 9 (llama3.2-3b and mamba2-780m
at prompt 2,048, recurrentgemma-2b at 4,096; bf16, weights seeded as
there, batch 4, 16 new tokens) takes a warm-up `generate` on 128 tokens,
then `--samples` timed ones.  The last line is one JSON object: the card
(name and power limit from nvidia-smi), the tree, and per model the
median, min and max of prefill ms and of decode ms/token with every
sample.

To compare two trees, unpack the other one (`git archive`) into a
directory that .gitignore lists and run this once per tree in turns on
one machine (parent, change, change, parent): each run imports only the
tree it is given, and its kernels build into that tree's build/.  It uses
only entry points that every tree since the recurrent models were ported
has: `get_config`, `transformer.init_params` and `launch.serve.generate`.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

SERVE = (("llama3.2-3b", 2048), ("mamba2-780m", 2048),
         ("recurrentgemma-2b", 4096))
BATCH, GEN = 4, 16


def spread(xs):
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs),
            "samples": xs}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"),
                    help="the src/ directory of the tree to time")
    ap.add_argument("--samples", type=int, default=5)
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    src = Path(args.src).resolve()
    if not (src / "repro_torch").is_dir():
        print(f"serve_timing: no repro_torch package under {src}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        print("serve_timing: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer as TF
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    out = {"label": args.label, "src": str(src), "card": card,
           "samples": args.samples, "models": {}}
    for arch, S in SERVE:
        cfg = get_config(arch)
        model = TF.init_params(cfg, torch.Generator(device="cuda")
                               .manual_seed(0), device="cuda")
        tokens = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                   (BATCH, S))
        generate(model, cfg, {"tokens": tokens[:, :128]}, 2,
                 prefill_impl="kernel", device="cuda")
        prefill, decode = [], []
        for _ in range(args.samples):
            _, prefill_s, decode_ms = generate(
                model, cfg, {"tokens": tokens}, GEN, prefill_impl="kernel",
                device="cuda")
            prefill.append(prefill_s * 1e3)
            decode.append(decode_ms)
        out["models"][arch] = {"prefill_ms": spread(prefill),
                               "decode_ms_per_token": spread(decode)}
        print(f"[serve_timing] {args.label} {arch}: prefill ms "
              f"{statistics.median(prefill):.2f} median "
              f"({min(prefill):.2f}-{max(prefill):.2f}), decode ms/token "
              f"{statistics.median(decode):.3f} median "
              f"({min(decode):.3f}-{max(decode):.3f})", flush=True)
        del model
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
