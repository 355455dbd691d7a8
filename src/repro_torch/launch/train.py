"""Training launcher (port of `repro.launch.train`): --arch <id> on one
device or on a mesh, with checkpointing, fault tolerance and straggler
monitoring.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \
        --steps 100 --batch 8 --seq 128 [--smoke]
    torchrun --nproc-per-node 8 -m repro_torch.launch.train --arch ...

--smoke uses the reduced same-family config with `naive` attention and no
remat; without it the full architecture config trains with `chunked`
attention and remat, on the card (CUDA unless `main` is given
``device="cpu"``).

Meshes, as the reference's launcher: when a process group is up (one the
caller initialised, or one from torchrun's RANK / WORLD_SIZE, NCCL on
CUDA and gloo on the CPU) the launcher trains through `Trainer(...,
mesh=mesh)` on `make_host_mesh(model=1)`, or with `--production-mesh`
on `make_production_mesh()` (256 ranks; with `--multi-pod`, which
implies it, 512).  The production meshes need a group of exactly that
size, and say so, before any weight is built; with no group the launcher
trains on one device and `--production-mesh` raises.  `launch.dryrun`
traces the production meshes without weights.

As in the reference, the data stream is wrapped in a `Prefetcher`, and a
restore rewinds only the inner stream: the batches already queued are
consumed after a restart.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from .. import env_int
from ..checkpoint.checkpointing import Checkpointer
from ..configs.registry import ARCHS, get_config
from ..data.pipeline import Prefetcher, SyntheticTokens
from ..device import resolve_device
from .mesh import make_host_mesh, make_production_mesh
from ..optim.optimizer import OptConfig
from ..runtime.fault_tolerance import (FailureInjector, FaultTolerantLoop,
                                       StragglerMonitor)
from ..runtime.trainer import Trainer, TrainSetup


def _process_group(device: torch.device):
    """(whether a process group is up, whether this call started it, the
    rank's device): the group the caller initialised, else one from
    torchrun's RANK / WORLD_SIZE (NCCL on CUDA, on card LOCAL_RANK; gloo
    on the CPU), else none."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return True, False, device
    world = env_int("WORLD_SIZE", 0)
    if world < 1:
        return False, False, device
    if device.type == "cuda":
        device = torch.device("cuda", env_int("LOCAL_RANK", 0))
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            rank=env_int("RANK", 0), world_size=world)
    return True, True, device


def _mesh(args, device: torch.device, group: bool):
    """The mesh to train on (None: one device), raising before any weight
    exists when the production mesh and the group's size disagree."""
    production = args.production_mesh or args.multi_pod
    need = 512 if args.multi_pod else 256
    flag = "--multi-pod" if args.multi_pod else "--production-mesh"
    if not group:
        if production:
            raise ValueError(
                f"{flag} trains on a {need}-rank process group (torchrun "
                f"or an initialised torch.distributed group); none is up")
        return None
    import torch.distributed as dist
    world = dist.get_world_size()
    if production:
        if world != need:
            raise ValueError(
                f"{flag} needs a {need}-rank process group; this one has "
                f"{world} ranks")
        return make_production_mesh(multi_pod=args.multi_pod,
                                    device_type=device.type)
    return make_host_mesh(model=1, device_type=device.type)


def main(argv=None, device=None) -> Trainer:
    """The reference's command line.  Runs on CUDA unless `device` says
    otherwise, on a mesh when a process group is up (see the module
    docstring); returns the trainer (its `history` holds every step's
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
    group, own, dev = _process_group(resolve_device(device))
    try:
        return _train(args, dev, _mesh(args, dev, group))
    finally:
        if own:
            import torch.distributed as dist
            dist.destroy_process_group()


def _train(args, device, mesh) -> Trainer:
    """The reference's training run on `device`, through `mesh` if any."""
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
                 ckpt_every=args.ckpt_every, device=device, mesh=mesh)
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
