"""Weights across the two packages: the reference's `init_params` tree (as
numpy arrays) into the port's `Transformer`, number for number.

The tree's stacked ``blocks`` and ``encoder`` leaves carry a leading
group or layer axis (the reference builds them with `jax.vmap`): leaf
``blocks.sub<j>.mix.q.w`` of shape ``[groups, d_in, d_out]`` fills
parameter ``blocks.<g>.sub<j>.mix.q.w`` with its slice ``g``, and leaf
``encoder.mix.q.w`` of shape ``[encoder_layers, d_in, d_out]`` fills
``encoder.<i>.mix.q.w`` with its slice ``i``.  Dense weights keep the reference's ``[d_in, d_out]``
layout, norm scales, the MoE router and the recurrent blocks' fp32 leaves
(`A_log`, `D`, `dt_bias`, `lam`) stay fp32 in a bf16 model, stacked MoE
experts carry ``[groups, E, D, F]``, and a tied model has no ``lm_head``
(the logits use ``embed``).

`opt_state_from_jax` carries the reference's AdamW state (`master`, `m`,
`v`, `step`) across the same way, into the port's `init_opt_state`
layout.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..optim.optimizer import init_opt_state
from .transformer import Transformer


# the reference's param subtrees stacked with a leading axis
STACKED = ("blocks", "encoder")


def _tensor(a) -> torch.Tensor:
    """numpy (including ml_dtypes' bfloat16) -> CPU tensor, bits kept.  The
    array is copied: arrays taken from JAX are read-only."""
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield path, tree


def _leaf_of(leaves: dict, name: str, used: dict) -> torch.Tensor:
    """The tree's numbers for the port's parameter `name` (slice g of a
    stacked leaf for ``blocks.<g>.…`` and ``encoder.<g>.…``), as a CPU
    tensor; counts the leaf's use in `used`."""
    parts = tuple(name.split("."))
    if parts[0] in STACKED:
        path, index = (parts[0],) + parts[2:], int(parts[1])
    else:
        path, index = parts, None
    if path not in leaves:
        raise KeyError(f"no leaf {'.'.join(path)} for parameter {name}")
    used[path] = used.get(path, 0) + 1
    return _tensor(leaves[path] if index is None else leaves[path][index])


def _fill(tree, named: dict, what: str, dtype=None) -> None:
    """Copy the leaves of `tree` into the tensors of `named` (name ->
    tensor), each leaf in `dtype` or its tensor's dtype.  Raises on a
    missing or unused leaf (or slice of a stacked leaf), or a shape or
    dtype that does not match."""
    leaves = dict(_leaves(tree))
    used = {}
    with torch.no_grad():
        for name, dst in named.items():
            try:
                src = _leaf_of(leaves, name, used)
            except KeyError as e:
                raise KeyError(f"{what}: {e.args[0]}") from None
            want = dtype or dst.dtype
            if src.shape != dst.shape or src.dtype != want:
                raise ValueError(
                    f"{what}: {name} is {want} {tuple(dst.shape)}, the "
                    f"tree's leaf {src.dtype} {tuple(src.shape)}")
            dst.copy_(src)
    unused = sorted(".".join(p) for p in leaves
                    if used.get(p, 0) != (len(leaves[p]) if p[0] in STACKED
                                          else 1))
    if unused:
        raise KeyError(f"{what}: leaves with no parameter: {unused}")


def params_from_jax(tree: dict, cfg: ModelConfig, device=None) -> Transformer:
    """The port's model holding the numbers of the reference's param tree
    `tree` (nested dicts and lists of numpy arrays), on `device` (CUDA
    unless the caller passes ``device="cpu"``).  Raises on a missing or
    unused leaf, or a shape or dtype that does not match."""
    device = resolve_device(device)
    model = Transformer(cfg, device)
    _fill(tree, dict(model.named_parameters()), "params_from_jax")
    return model


def opt_state_from_jax(tree: dict, model: Transformer) -> dict:
    """The port's optimizer state (`optim.optimizer.init_opt_state`'s
    layout, on the model's device) holding the reference's: `tree` is its
    ``{"master", "m", "v", "step"}`` as numpy arrays, the first three fp32
    trees shaped as the model's param tree."""
    state = init_opt_state(model)
    for part in ("master", "m", "v"):
        _fill(tree[part], state[part], f"opt_state_from_jax {part}",
              torch.float32)
    state["step"].fill_(int(np.asarray(tree["step"])))
    return state
