"""Train, prefill and decode steps, the sharded train step, plus the
host-side training loop used by the launcher and the fault-tolerance
harness (port of `repro.runtime.trainer`).

Steps run eagerly.  The train step takes its gradients with
`torch.autograd.grad`; with `microbatch` k > 1 it sums each
microbatch's ``g.float() / k`` into fp32 buffers and ``loss / k`` into a
scalar, as the reference's scan does (``.grad`` accumulation across
backward calls would sum in the params' bf16).

With a `DeviceMesh` (an initialised `torch.distributed` process group
of the mesh's size), `jit_train_step` places the parameters, the AdamW
state and each batch as DTensors by `runtime.sharding`'s specs - the
reference's `in_shardings` - and the steps pass `make_constrain(mesh)`
into the model, so DTensor issues the collectives GSPMD would.  Without
a mesh every step is the one-device path.
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
from ..models.placement import is_dt, keep
from . import sharding as SH


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


def _placed(batch: dict, mesh, device) -> dict:
    """The batch on `device`, and on a mesh placed by `batch_specs` (an
    input that is already a DTensor stays as it is)."""
    if mesh is None:
        return _on(batch, device)
    specs = SH.batch_specs(batch, mesh)
    return {k: v if is_dt(v) else SH.distribute(
        torch.as_tensor(v).to(device), specs[k], mesh)
        for k, v in batch.items()}


def _device_of(model):
    p = next(iter(model.parameters()))
    return p.device if not is_dt(p) else p.to_local().device


def make_train_step(setup: TrainSetup, mesh=None):
    """train_step(model, opt_state, batch) -> (model, opt_state, metrics):
    one AdamW step of `model` on `batch` (tokens, labels [B, S]; numpy or
    tensors), updating the model and the state in place.  The metrics
    (loss, nll, aux, lr, grad_norm) are fp32 scalar tensors on the
    model's device.  With a `mesh`, the batch is placed by `batch_specs`
    and the model runs with `make_constrain(mesh)`; the model and the
    state must already be placed (`jit_train_step`)."""
    cfg = setup.model
    constrain = SH.make_constrain(mesh) if mesh is not None else None

    def grads_of(model, params, batch):
        loss, metrics = TF.lm_loss(model, cfg, batch,
                                   attn_impl=setup.attn_impl,
                                   remat=setup.remat, constrain=constrain)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def train_step(model, opt_state, batch):
        params = dict(model.named_parameters())
        batch = _placed(batch, mesh, _device_of(model))
        k = setup.microbatch
        if k <= 1:
            loss, metrics, grads = grads_of(model, params, batch)
        else:
            B = batch["tokens"].shape[0]
            grads = {n: torch.zeros_like(p, dtype=torch.float32)
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


def _next_tokens(logits):
    """Greedy next tokens [B, 1] int32 from the last position's logits; on
    a DTensor the vocab shards of that position are gathered first."""
    last = logits[:, -1:]
    if is_dt(last):
        last = last.redistribute(last.device_mesh, keep(last, (0,)))
    return torch.argmax(last, dim=-1).int()


def make_prefill_step(setup: TrainSetup, mesh=None):
    """prefill_step(model, batch, cache) -> (next tokens [B, 1] int32,
    cache): the prompt through `setup.attn_impl`, the cache filled in
    place.  With a `mesh`, the model runs with `make_constrain(mesh)`
    (the model, the batch and the cache placed by the caller)."""
    cfg = setup.model
    constrain = SH.make_constrain(mesh) if mesh is not None else None

    @torch.no_grad()
    def prefill_step(model, batch, cache):
        logits, cache, _ = TF.forward(model, cfg, batch, mode="prefill",
                                      cache=cache, attn_impl=setup.attn_impl,
                                      remat=False, constrain=constrain)
        return _next_tokens(logits), cache

    return prefill_step


def make_decode_step(setup: TrainSetup, mesh=None):
    """decode_step(model, batch, cache) -> (next tokens [B, 1] int32,
    cache): one token against the cache, the exact single-token branch.
    As in the reference, the decode step applies no constraint; `mesh`
    is accepted for the same signature."""
    cfg = setup.model

    @torch.no_grad()
    def decode_step(model, batch, cache):
        logits, cache, _ = TF.forward(model, cfg, batch, mode="decode",
                                      cache=cache, attn_impl="naive",
                                      remat=False)
        return _next_tokens(logits), cache

    return decode_step


def place_model(model, specs: dict, mesh) -> None:
    """Replace every parameter of `model` by a DTensor parameter of its
    spec on `mesh`, in place (a parameter already a DTensor stays)."""
    for name, spec in specs.items():
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        p = getattr(mod, leaf)
        if is_dt(p):
            continue
        setattr(mod, leaf, torch.nn.Parameter(
            SH.distribute(p.detach(), spec, mesh),
            requires_grad=p.requires_grad))


def place_tree(tree, specs, mesh):
    """`tree` (dicts and lists of tensors) with every tensor a DTensor of
    the same position's spec in `specs`; dicts are updated in place."""
    if isinstance(tree, dict):
        for k in tree:
            tree[k] = place_tree(tree[k], specs[k], mesh)
        return tree
    if isinstance(tree, list):
        tree[:] = [place_tree(t, sp, mesh) for t, sp in zip(tree, specs)]
        return tree
    return tree if is_dt(tree) else SH.distribute(tree, specs, mesh)


def train_specs(model, mesh, batch_shapes=None) -> tuple:
    """(param specs, opt-state specs, batch specs) of `model` on `mesh`,
    the reference's `pspec_tree`."""
    pspecs = SH.tree_param_specs(model, mesh)
    ospecs = SH.opt_specs(pspecs, model, mesh)
    bspecs = SH.batch_specs(batch_shapes, mesh) \
        if batch_shapes is not None else None
    return pspecs, ospecs, bspecs


def jit_train_step(setup: TrainSetup, mesh, batch_shapes):
    """The fully sharded train step: returns ``build(model, opt_state)``,
    which returns ``step(model, opt_state, batch)``.  The step's first
    call places the model's parameters, the AdamW state and the batch as
    DTensors by `tree_param_specs` / `opt_state_specs` / `batch_specs`,
    in place (the counterpart of the reference's donated, sharded
    arguments; later calls find them placed); every call then runs
    `make_train_step(setup, mesh)`.
    ``build.pspec_tree`` and ``step.pspec_tree`` are the three spec
    trees."""

    def build(model, opt_state):
        pspecs, ospecs, bspecs = train_specs(model, mesh, batch_shapes)
        build.pspec_tree = (pspecs, ospecs, bspecs)
        fn = make_train_step(setup, mesh)

        def step(model, opt_state, batch):
            # a no-op once placed: DTensors stay as they are
            place_model(model, pspecs, mesh)
            place_tree(opt_state, ospecs, mesh)
            return fn(model, opt_state, batch)

        step.pspec_tree = build.pspec_tree
        return step

    build.pspec_tree = None
    return build


def full(t):
    """The full tensor of a DTensor (a collective: every rank calls it);
    a plain tensor as it is."""
    return t.full_tensor() if is_dt(t) else t


class Trainer:
    """Host loop: data -> train step -> metrics / checkpoints, on `device`
    (CUDA unless the caller passes ``device="cpu"``).  The model is
    `init_params` with a generator seeded by `seed` on that device.

    With a `mesh` (a `DeviceMesh` on `device`'s type), the model and the
    AdamW state are placed by the reference's specs at construction, as
    the reference's `__init__` does, and every step goes through
    `jit_train_step`; checkpoints hold the full tensors, so their bytes
    are the one-device run's.  Without one (the default), the one-device
    eager path."""

    def __init__(self, setup: TrainSetup, data_it, checkpointer=None,
                 ckpt_every: int = 0, seed: int = 0, device=None, mesh=None):
        self.setup = setup
        self.device = resolve_device(device)
        self.mesh = mesh
        self.data = data_it
        self.ckpt = checkpointer
        self.ckpt_every = ckpt_every
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.model = TF.init_params(setup.model, gen, device=self.device)
        self.opt_state = init_opt_state(self.model)
        if mesh is None:
            self._step_fn = make_train_step(setup)
            self.pspecs = self.ospecs = None
        else:
            self.pspecs, self.ospecs, _ = train_specs(self.model, mesh)
            place_model(self.model, self.pspecs, mesh)
            place_tree(self.opt_state, self.ospecs, mesh)
            self._step_fn = jit_train_step(setup, mesh, None)(
                self.model, self.opt_state)
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
            metrics = {k: float(full(v)) for k, v in metrics.items()}
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
        state and the data stream's position (full tensors on a mesh)."""
        return {"params": {n: full(p) for n, p in
                           self.model.named_parameters()},
                "opt": _tree_full(self.opt_state),
                "data": {"step": np.asarray(self.data.state()["step"],
                                            np.int32)}}

    def save(self, blocking: bool = True):
        state = self.state()
        if self.mesh is None or _rank() == 0:
            self.ckpt.save(self.step, state, blocking=blocking)

    def restore(self, step=None):
        """Load a snapshot (the newest by default) into the model and the
        optimizer state, rewind the data stream; returns its step."""
        tmpl = self.state()
        state, ck_step = self.ckpt.restore(tmpl, step)
        with torch.no_grad():
            _copy_into(dict(self.model.named_parameters()), state["params"])
            _copy_into(self.opt_state, state["opt"])
        self.data.restore({"step": int(state["data"]["step"])})
        self.step = ck_step
        return ck_step


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _tree_full(tree):
    if isinstance(tree, dict):
        return {k: _tree_full(v) for k, v in tree.items()}
    return full(tree)


def _copy_into(dst, src):
    """Copy the host tree `src` into the tensors of the tree `dst` (a
    DTensor receives its shard of the full host tensor)."""
    if isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    elif is_dt(dst):
        from torch.distributed.tensor import distribute_tensor
        dst.copy_(distribute_tensor(
            torch.as_tensor(src).to(dst.to_local().device), dst.device_mesh,
            dst.placements, src_data_rank=None))
    else:
        dst.copy_(torch.as_tensor(src))
