"""Weights across the two packages: the reference's `init_params` tree (as
numpy arrays) into the port's `Transformer`, number for number.

The tree's stacked ``blocks`` leaves carry a leading group axis (the
reference builds them with `jax.vmap`): leaf ``blocks.sub<j>.mix.q.w`` of
shape ``[groups, d_in, d_out]`` fills parameter ``blocks.<g>.sub<j>.mix.q.w``
with its slice ``g``.  Dense weights keep the reference's ``[d_in, d_out]``
layout, norm scales and the recurrent blocks' fp32 leaves (`A_log`, `D`,
`dt_bias`, `lam`) stay fp32 in a bf16 model, and a tied model has no
``lm_head`` (the logits use ``embed``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from .transformer import Transformer


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


def params_from_jax(tree: dict, cfg: ModelConfig, device=None) -> Transformer:
    """The port's model holding the numbers of the reference's param tree
    `tree` (nested dicts and lists of numpy arrays), on `device` (CUDA
    unless the caller passes ``device="cpu"``).  Raises on a missing or
    unused leaf, or a shape or dtype that does not match."""
    device = resolve_device(device)
    model = Transformer(cfg, device)
    leaves = dict(_leaves(tree))
    used = set()
    with torch.no_grad():
        for name, param in model.named_parameters():
            parts = tuple(name.split("."))
            if parts[0] == "blocks":
                path, index = ("blocks",) + parts[2:], int(parts[1])
            else:
                path, index = parts, None
            if path not in leaves:
                raise KeyError(f"params_from_jax: no leaf {'.'.join(path)} "
                               f"for parameter {name}")
            used.add(path)
            src = _tensor(leaves[path] if index is None
                          else leaves[path][index])
            if src.shape != param.shape or src.dtype != param.dtype:
                raise ValueError(
                    f"params_from_jax: {name} is {param.dtype} "
                    f"{tuple(param.shape)}, the tree's leaf {src.dtype} "
                    f"{tuple(src.shape)}")
            param.copy_(src)
    unused = sorted(".".join(p) for p in set(leaves) - used)
    if unused:
        raise KeyError(f"params_from_jax: leaves with no parameter: "
                       f"{unused}")
    return model
