"""Training launcher (port of `repro.launch.train`): --arch <id> on one
device, with checkpointing, fault tolerance and straggler monitoring.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \
        --steps 100 --batch 8 --seq 128 [--smoke]

--smoke uses the reduced same-family config with `naive` attention and no
remat; without it the full architecture config trains with `chunked`
attention and remat, on the card (CUDA unless `main` is given
``device="cpu"``).  The production meshes (`--production-mesh`,
`--multi-pod`: 256 or 512 ranks) are multi-device placement and raise;
`Trainer(..., mesh=...)` trains sharded on the mesh of a process group,
and `launch.dryrun` traces the production meshes without weights.

As in the reference, the data stream is wrapped in a `Prefetcher`, and a
restore rewinds only the inner stream: the batches already queued are
consumed after a restart.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from ..checkpoint.checkpointing import Checkpointer
from ..configs.registry import ARCHS, get_config
from ..data.pipeline import Prefetcher, SyntheticTokens
from ..optim.optimizer import OptConfig
from ..runtime.fault_tolerance import (FailureInjector, FaultTolerantLoop,
                                       StragglerMonitor)
from ..runtime.trainer import Trainer, TrainSetup


def main(argv=None, device=None) -> Trainer:
    """The reference's command line.  Runs on CUDA unless `device` says
    otherwise; returns the trainer (its `history` holds every step's
    metrics)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch-ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, default=0)
    args = ap.parse_args(argv)
    if args.production_mesh or args.multi_pod:
        raise NotImplementedError(
            "the production meshes are multi-device placement, not ported "
            "yet (ROADMAP queue 1 item 7); the port trains on one device")

    cfg = get_config(args.arch + ("-smoke" if args.smoke else ""))
    opt = OptConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                    total_steps=args.steps, schedule=cfg.schedule)
    setup = TrainSetup(model=cfg, opt=opt,
                       attn_impl="naive" if args.smoke else "chunked",
                       remat=not args.smoke, microbatch=args.microbatch)
    data = Prefetcher(SyntheticTokens(cfg.vocab_size, args.batch, args.seq))
    # Prefetcher wraps the stream; Trainer needs state()/restore() from the
    # underlying stream for checkpointing
    data.state = data.it.state
    data.restore = data.it.restore
    ckpt = Checkpointer(args.ckpt_dir, keep=3)
    tr = Trainer(setup, data, checkpointer=ckpt,
                 ckpt_every=args.ckpt_every, device=device)
    mon = StragglerMonitor()

    def on_step(step, metrics, dt):
        mon.observe(step, dt)
        if step % 10 == 0 or step == 1:
            print(f"step {step:5d}  loss {metrics['loss']:.3f}  "
                  f"lr {metrics['lr']:.2e}  {dt * 1e3:.0f} ms", flush=True)

    try:
        if args.fail_at:
            loop = FaultTolerantLoop(
                tr, FailureInjector(fail_at=(args.fail_at,)), mon)
            loop.run(args.steps)
            print("recovery log:", loop.log)
        else:
            tr.run(args.steps, on_step=on_step)
    finally:
        # end the prefetch thread: it sees `done` after its next batch
        data.stop()
        for _ in data:
            pass
    print(f"done at step {tr.step}; straggler events: {len(mon.events)}")
    return tr


if __name__ == "__main__":
    main()
