"""End-to-end training driver on the PyTorch/CUDA port: train a
~100M-param MiniCPM-family model on the synthetic pipeline with WSD,
checkpointing and fault tolerance enabled (the port of
`examples/train_lm.py`, on one device: no mesh).

Run from the repo root (after `pip install -e .`, or `PYTHONPATH=src`):

    python -m examples.torch_train_lm --steps 300                # on the GPU
    python -m examples.torch_train_lm --steps 40 --inject-failure-at 25 \
        --ckpt-every 10
    python -m examples.torch_train_lm --device cpu --d-model 64 --layers 2

The model is the architecture's config reduced in width and depth
(`--d-model`, `--layers`; 8 heads of 64) at its full vocabulary.  A
failure injected at a step restarts from the newest snapshot, so it
needs one written before it: `--ckpt-every` (the reference script's
fixed 50) sets how often.
"""
import argparse
import dataclasses
import os
import tempfile

from repro_torch.checkpoint.checkpointing import Checkpointer
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.optim.optimizer import OptConfig
from repro_torch.runtime.fault_tolerance import (FailureInjector,
                                                 FaultTolerantLoop,
                                                 StragglerMonitor)
from repro_torch.runtime.trainer import Trainer, TrainSetup


def reduced_config(arch: str, d_model: int, layers: int):
    """The reference script's width/depth-reduced config of `arch`."""
    base = get_config(arch)
    return dataclasses.replace(
        base, num_layers=layers, d_model=d_model,
        num_heads=8, num_kv_heads=8 if base.num_kv_heads == base.num_heads
        else 2, d_ff=d_model * 3 if base.d_ff else 0, head_dim=64)


def main(argv=None, device=None) -> Trainer:
    """The reference script's command line, on `device` (the `--device`
    flag; CUDA when neither names one).  Raises unless the mean nll of
    the last 10 steps is below that of the first 10; returns the
    trainer."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch-train-ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--inject-failure-at", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device or device)

    cfg = reduced_config(args.arch, args.d_model, args.layers)
    print(f"model: {cfg.name} reduced to "
          f"{cfg.num_params() / 1e6:.0f}M params "
          f"({cfg.num_layers}L x {cfg.d_model}d, vocab {cfg.vocab_size})")

    opt = OptConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps,
                    schedule=cfg.schedule, weight_decay=0.01)
    setup = TrainSetup(model=cfg, opt=opt, attn_impl="chunked", remat=False)
    data = SyntheticTokens(cfg.vocab_size, batch=args.batch,
                           seq_len=args.seq, seed=0)
    ckpt = Checkpointer(args.ckpt_dir, keep=2)
    tr = Trainer(setup, data, checkpointer=ckpt, ckpt_every=args.ckpt_every,
                 device=dev)
    mon = StragglerMonitor()

    if args.inject_failure_at:
        loop = FaultTolerantLoop(
            tr, FailureInjector(fail_at=(args.inject_failure_at,)), mon)
        loop.run(args.steps)
        print("fault-tolerance log:", loop.log)
        hist = tr.history
    else:
        def on_step(step, metrics, dt):
            mon.observe(step, dt)
            if step % 20 == 0 or step == 1:
                print(f"step {step:4d}  loss {metrics['loss']:.3f}  "
                      f"nll {metrics['nll']:.3f}  lr {metrics['lr']:.2e}  "
                      f"{dt * 1e3:.0f} ms")
        hist = tr.run(args.steps, on_step=on_step)

    first = sum(h["nll"] for h in hist[:10]) / 10
    last = sum(h["nll"] for h in hist[-10:]) / 10
    print(f"\nnll: {first:.3f} -> {last:.3f} over {len(hist)} steps "
          f"({len(mon.events)} straggler events)")
    if not last < first:
        raise RuntimeError(f"training must reduce loss: nll {first:.3f} -> "
                           f"{last:.3f}")
    print("OK")
    return tr


if __name__ == "__main__":
    main()
