"""Run the port's simulation service from the command line (port of
`repro.exp.serve.cli`, the same flags).

    python -m repro_torch.exp.serve --inbox specs/ --out serve.jsonl
    python -m repro_torch.exp.serve --stdin --out serve.jsonl < specs.jsonl
    python -m repro_torch.exp.serve --inbox specs/ --state-dir ckpt \\
        --checkpoint-every 2 --max-rounds 3 --out serve.jsonl
    python -m repro_torch.exp.serve --resume --state-dir ckpt --out serve.jsonl

Specs are JSON: either a bare `ExperimentSpec.to_dict()` payload, a
`{"scenario": "smoke"}` registry reference, or either form wrapped as
`{"tenant": "alice", "spec": ...}`.  `--inbox DIR` reads `*.json` files
in sorted name order (one submission each); `--stdin` reads JSONL, one
submission per line; the two compose.  `--max-rounds N` stops after N
service rounds, leaving a final snapshot when `--state-dir` is set —
the kill half of a kill+resume run; `--resume` rebuilds the
service from the latest snapshot (new submissions may still be added)
and APPENDS to `--out`.  Exit status 0 when the queue drained, 3 when
`--max-rounds` stopped it early (resumable).  The service runs on CUDA;
`main(argv, device="cpu")` runs it on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from .. import registry
from ..spec import ExperimentSpec
from .service import SimService


def _parse_submission(payload: dict) -> tuple[str, ExperimentSpec]:
    tenant = "default"
    if "tenant" in payload or "spec" in payload:
        tenant = payload.get("tenant", "default")
        payload = payload.get("spec", payload)
    if isinstance(payload, str) or "scenario" in payload:
        name = payload if isinstance(payload, str) else payload["scenario"]
        return tenant, registry.get_scenario(name)
    return tenant, ExperimentSpec.from_dict(payload)


def _read_inbox(path: str):
    for name in sorted(os.listdir(path)):
        if name.endswith(".json"):
            with open(os.path.join(path, name)) as f:
                yield _parse_submission(json.load(f))


def _read_stdin():
    for line in sys.stdin:
        line = line.strip()
        if line:
            yield _parse_submission(json.loads(line))


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.exp.serve", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--inbox", help="directory of *.json submissions "
                                    "(sorted name order)")
    ap.add_argument("--stdin", action="store_true",
                    help="read JSONL submissions from stdin")
    ap.add_argument("--out", required=True,
                    help="JSONL output path (appended to under --resume)")
    ap.add_argument("--state-dir", default=None,
                    help="checkpoint directory (enables snapshots)")
    ap.add_argument("--resume", action="store_true",
                    help="rebuild from the latest snapshot in --state-dir")
    ap.add_argument("--max-rounds", type=int, default=None,
                    help="stop after N rounds (leaves a snapshot)")
    ap.add_argument("--window", type=int, default=None,
                    help="cycles per window (default REPRO_SERVE_WINDOW)")
    ap.add_argument("--pack", type=int, default=None,
                    help="lanes per pack (default REPRO_SERVE_PACK)")
    ap.add_argument("--max-active", type=int, default=None,
                    help="bound concurrent sessions (default unbounded)")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="snapshot every N rounds (0 = only at exit)")
    ap.add_argument("--keep", type=int, default=3,
                    help="snapshot retention (newest K)")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress progress on stderr")
    args = ap.parse_args(argv)

    if args.resume:
        if not args.state_dir:
            print("ERROR: --resume needs --state-dir", file=sys.stderr)
            return 2
        svc = SimService.resume(args.state_dir, out=args.out,
                                verbose=not args.quiet, device=device)
    else:
        svc = SimService(out=args.out, window=args.window, pack=args.pack,
                         max_active=args.max_active,
                         state_dir=args.state_dir,
                         checkpoint_every=args.checkpoint_every,
                         keep=args.keep, verbose=not args.quiet,
                         device=device)
    with svc:
        if args.inbox:
            for tenant, spec in _read_inbox(args.inbox):
                svc.submit(spec, tenant=tenant)
        if args.stdin:
            for tenant, spec in _read_stdin():
                svc.submit(spec, tenant=tenant)
        if svc.idle:
            print("ERROR: nothing to run (no submissions, no resumed "
                  "work)", file=sys.stderr)
            return 2
        rounds = svc.run(max_rounds=args.max_rounds)
        drained = svc.idle
        print(f"[serve] {rounds} rounds, "
              f"{'queue drained' if drained else 'stopped with work left'}"
              f" (capture {svc.compile_s:.1f}s) -> {args.out}",
              file=sys.stderr)
    return 0 if drained else 3


if __name__ == "__main__":
    raise SystemExit(main())
