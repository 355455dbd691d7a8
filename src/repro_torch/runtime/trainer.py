"""Train, prefill and decode steps, plus the host-side training loop used
by the launcher and the fault-tolerance harness (port of
`repro.runtime.trainer` on one device: where the reference takes a mesh,
the port takes the device; the sharded `jit_train_step` waits for
`runtime/sharding.py`).

Steps run eagerly.  The train step takes its gradients with
`torch.autograd.grad`; with `microbatch` k > 1 it sums each
microbatch's ``g.float() / k`` into fp32 buffers and ``loss / k`` into a
scalar, as the reference's scan does (``.grad`` accumulation across
backward calls would sum in the params' bf16).
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..models import transformer as TF
from ..optim.optimizer import OptConfig, adamw_update, init_opt_state


@dataclass(frozen=True)
class TrainSetup:
    model: ModelConfig
    opt: OptConfig
    attn_impl: str = "chunked"
    remat: bool = True
    # gradient accumulation: split the global batch into this many
    # microbatches - divides activation memory by the same factor
    microbatch: int = 1


def _on(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_train_step(setup: TrainSetup):
    """train_step(model, opt_state, batch) -> (model, opt_state, metrics):
    one AdamW step of `model` on `batch` (tokens, labels [B, S]; numpy or
    tensors), updating the model and the state in place.  The metrics
    (loss, nll, aux, lr, grad_norm) are fp32 scalar tensors on the
    model's device."""
    cfg = setup.model

    def grads_of(model, params, batch):
        loss, metrics = TF.lm_loss(model, cfg, batch,
                                   attn_impl=setup.attn_impl,
                                   remat=setup.remat)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def train_step(model, opt_state, batch):
        params = dict(model.named_parameters())
        batch = _on(batch, next(iter(params.values())).device)
        k = setup.microbatch
        if k <= 1:
            loss, metrics, grads = grads_of(model, params, batch)
        else:
            B = batch["tokens"].shape[0]
            grads = {n: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for n, p in params.items()}
            loss, mets = 0.0, []
            for i in range(k):
                mb = {n: x[i * (B // k):(i + 1) * (B // k)]
                      for n, x in batch.items()}
                l, met, g = grads_of(model, params, mb)
                for n, gn in g.items():
                    grads[n] += gn.float() / k
                loss = loss + l / k
                mets.append(met)
            metrics = {n: torch.stack([m[n] for m in mets]).mean()
                       for n in mets[0]}
        _, opt_state, om = adamw_update(setup.opt, grads, opt_state, params)
        return model, opt_state, dict(loss=loss, **metrics, **om)

    return train_step


def make_prefill_step(setup: TrainSetup):
    """prefill_step(model, batch, cache) -> (next tokens [B, 1] int32,
    cache): the prompt through `setup.attn_impl`, the cache filled in
    place."""
    cfg = setup.model

    @torch.no_grad()
    def prefill_step(model, batch, cache):
        logits, cache, _ = TF.forward(model, cfg, batch, mode="prefill",
                                      cache=cache, attn_impl=setup.attn_impl,
                                      remat=False)
        return torch.argmax(logits[:, -1:], dim=-1).int(), cache

    return prefill_step


def make_decode_step(setup: TrainSetup):
    """decode_step(model, batch, cache) -> (next tokens [B, 1] int32,
    cache): one token against the cache, the exact single-token branch."""
    cfg = setup.model

    @torch.no_grad()
    def decode_step(model, batch, cache):
        logits, cache, _ = TF.forward(model, cfg, batch, mode="decode",
                                      cache=cache, attn_impl="naive",
                                      remat=False)
        return torch.argmax(logits[:, -1:], dim=-1).int(), cache

    return decode_step


class Trainer:
    """Host loop: data -> train step -> metrics / checkpoints, on `device`
    (CUDA unless the caller passes ``device="cpu"``).  The model is
    `init_params` with a generator seeded by `seed` on that device."""

    def __init__(self, setup: TrainSetup, data_it, checkpointer=None,
                 ckpt_every: int = 0, seed: int = 0, device=None):
        self.setup = setup
        self.device = resolve_device(device)
        self.data = data_it
        self.ckpt = checkpointer
        self.ckpt_every = ckpt_every
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.model = TF.init_params(setup.model, gen, device=self.device)
        self.opt_state = init_opt_state(self.model)
        self._step_fn = make_train_step(setup)
        self.step = 0
        self.history = []
        self.step_times = []

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, steps: int, on_step=None):
        for _ in range(steps):
            batch = next(self.data)
            self._sync()
            t0 = time.perf_counter()
            _, self.opt_state, metrics = self._step_fn(
                self.model, self.opt_state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            self.step += 1
            self.step_times.append(dt)
            self.history.append(metrics)
            if on_step:
                on_step(self.step, metrics, dt)
            if (self.ckpt is not None and self.ckpt_every
                    and self.step % self.ckpt_every == 0):
                self.save()
        return self.history

    def state(self) -> dict:
        """The training state as a tree: params by name, the optimizer
        state and the data stream's position."""
        return {"params": dict(self.model.named_parameters()),
                "opt": self.opt_state,
                "data": {"step": np.asarray(self.data.state()["step"],
                                            np.int32)}}

    def save(self, blocking: bool = True):
        self.ckpt.save(self.step, self.state(), blocking=blocking)

    def restore(self, step=None):
        """Load a snapshot (the newest by default) into the model and the
        optimizer state, rewind the data stream; returns its step."""
        tmpl = self.state()
        state, ck_step = self.ckpt.restore(tmpl, step)
        with torch.no_grad():
            for part in ("params", "opt"):
                _copy_into(tmpl[part], state[part])
        self.data.restore({"step": int(state["data"]["step"])})
        self.step = ck_step
        return ck_step


def _copy_into(dst, src):
    """Copy the host tree `src` into the tensors of the tree `dst`."""
    if isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    else:
        dst.copy_(torch.as_tensor(src))
