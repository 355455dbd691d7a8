"""AdamW with WSD / cosine schedules, gradient clipping by the global norm,
and fp32 master copies of the (bf16) params (port of
`repro.optim.optimizer`).  On a mesh the params, gradients and state are
DTensors placed by `runtime.sharding` (the state ZeRO-sharded over
"data"), and the same arithmetic runs on them.

The state is ``{"master", "m", "v": {param name: fp32 tensor}, "step":
int32 scalar}``, keyed by the model's `named_parameters`.  Unlike the
reference, `adamw_update` updates the state and the params in place: at
full width the fp32 state is most of the memory, and a second copy would
not fit.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    min_lr_frac: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 1000
    decay_frac: float = 0.1        # WSD: last 10% of steps decay
    schedule: str = "cosine"       # "cosine" | "wsd" | "const"
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def schedule_lr(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at `step` (an int or an integer tensor) as an fp32
    scalar tensor, computed in fp32 as the reference does; WSD
    (warmup-stable-decay) is the MiniCPM schedule [arXiv:2404.06395]."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    if cfg.schedule == "cosine":
        frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) \
            * 0.5 * (1 + torch.cos(math.pi * t))
    elif cfg.schedule == "wsd":
        decay_start = 1.0 - cfg.decay_frac
        d = torch.clamp((t - decay_start) / cfg.decay_frac, 0, 1)
        frac = 1.0 - (1 - cfg.min_lr_frac) * d
    else:
        frac = torch.ones_like(t)
    return cfg.lr * warm * frac


def decays(name: str, param: torch.Tensor) -> bool:
    """Whether AdamW decays the parameter `name`: where its leaf on the
    reference's tree has more than one dim.  The reference stacks the
    scanned ``blocks`` with a leading group dim and the ``encoder`` with
    a leading layer dim, so there every leaf, norm scales and 1-D
    recurrent leaves included, is decayed; the same leaves in the
    prelude, the postlude and ``final_norm`` are not."""
    return param.dim() + name.startswith(("blocks.", "encoder.")) > 1


def init_opt_state(model) -> dict:
    """fp32 master weights (a copy even of fp32 params) and zeroed first
    and second moments, one a named parameter, on its device; step 0."""
    named = dict(model.named_parameters())
    device = next(iter(named.values())).device
    return {
        "master": {n: p.detach().to(torch.float32, copy=True)
                   for n, p in named.items()},
        "m": {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for n, p in named.items()},
        "v": {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for n, p in named.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tensors))


@torch.no_grad()
def adamw_update(cfg: OptConfig, grads: dict, opt_state: dict,
                 params: dict):
    """One AdamW step on `params` (name -> parameter) from `grads` (name ->
    gradient), in place, with the reference's arithmetic.  Returns
    (params, opt_state, {"lr", "grad_norm"} as fp32 scalar tensors)."""
    opt_state["step"] += 1
    step = opt_state["step"]
    lr = schedule_lr(cfg, step)
    gnorm = global_norm(grads.values())
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    c1 = 1 - torch.pow(b1, step.float())
    c2 = 1 - torch.pow(b2, step.float())
    for name, p in params.items():
        g = grads[name].float() * scale
        m, v, w = (opt_state[k][name] for k in ("m", "v", "master"))
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        upd = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        if decays(name, p):
            upd = upd + cfg.weight_decay * w
        w.sub_(lr * upd)
        p.copy_(w)
    return params, opt_state, {"lr": lr, "grad_norm": gnorm}
