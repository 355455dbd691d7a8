"""The model's few placement decisions on a mesh (DTensor).

The layers compute on plain tensors on one device and on DTensors on a
`DeviceMesh`; there, DTensor's sharding propagation decides each op's
layout, as GSPMD does for the reference's `with_sharding_constraint`
hints.  Where it cannot, these helpers decide, and each is the identity
on a plain tensor, so the one-device path is unchanged:

- `like(x, t)`: a tensor made in the forward (positions, a zero
  accumulator) joins the computation as a replicated DTensor on `x`'s
  mesh, since DTensor refuses to mix plain tensors and DTensors;
- `split_dim` / `merge_dims`: a view that splits a sharded dim into
  sizes the mesh does not divide (2 heads on a model axis of 4)
  replicates that dim first, in the forward and the backward pass,
  where GSPMD would reshard;
- `gather_inner` / `gather_inner_grad`: a sequence-sharded activation
  (and its gradient) is gathered before a projection, as Megatron
  sequence parallelism does, since DTensor's matrix product takes no
  shard of a flattened batch x sequence dim;
- `reduced`: a partial result (the vocab-parallel embedding and label
  gather) is reduced at once;
- `local(fn, ...)`: attention, the SSD mixer and the MoE dispatch run on
  each rank's local shard (`local_map`), which keeps the batch and the
  head (or expert) shard of their inputs and replicates the rest, so
  their loops issue no DTensor op.
"""
from __future__ import annotations

import torch


def is_dt(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def mesh_of(*ts):
    for t in ts:
        if is_dt(t):
            return t.device_mesh
    return None


def like(x, t):
    """`t` (a plain tensor, the same on every rank) as a replicated DTensor
    on `x`'s mesh when `x` is a DTensor; else `t`."""
    if not is_dt(x) or is_dt(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = x.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def split_dim(t, dim: int, sizes: tuple):
    """`t` with dim `dim` split into `sizes`.  On a DTensor whose shard of
    that dim the mesh cannot carry into the first new dim, the dim is
    replicated first."""
    if is_dt(t):
        t = _replicate_uneven(t, dim % t.ndim, sizes[0])
    shape = list(t.shape)
    d = dim % t.ndim
    return t.reshape(shape[:d] + list(sizes) + shape[d + 1:])


def gather_inner(t):
    """DTensor `t` with every shard of a dim other than the first and the
    last replicated; a plain tensor as it is."""
    if not is_dt(t) or t.ndim < 3:
        return t
    from torch.distributed.tensor import Replicate, Shard
    pl = [Replicate() if isinstance(p, Shard)
          and 0 < p.dim % t.ndim < t.ndim - 1 else p for p in t.placements]
    if pl == list(t.placements):
        return t
    return t.redistribute(t.device_mesh, pl)


class _GradRule(torch.autograd.Function):
    """The identity, whose backward passes the gradient through `rule`."""

    @staticmethod
    def forward(ctx, t, rule):
        ctx.rule = rule
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.rule(g), None


def _on_grad(t, rule):
    if not is_dt(t) or not t.requires_grad:
        return t
    return _GradRule.apply(t, rule)


def gather_inner_grad(t):
    """`t`, with the gradient that reaches it through autograd gathered as
    `gather_inner` gathers a value (a DTensor only; it keeps the matrix
    product behind `t` free of flattened shards in the backward pass)."""
    return _on_grad(t, gather_inner)


def _replicate_uneven(t, dim, first):
    from torch.distributed.tensor import Replicate, Shard
    pl = [Replicate() if isinstance(p, Shard) and p.dim % t.ndim == dim
          and first % t.device_mesh.size(i) else p
          for i, p in enumerate(t.placements)]
    if pl == list(t.placements):
        return t
    return t.redistribute(t.device_mesh, pl)


def merge_dims(t, dim: int):
    """`t` with dims `dim` and `dim + 1` merged into one.  On a DTensor the
    gradient that flows back is made splittable again (`split_dim`'s rule
    in the backward pass)."""
    shape = list(t.shape)
    d = dim % t.ndim
    out = t.reshape(shape[:d] + [shape[d] * shape[d + 1]] + shape[d + 2:])
    return _on_grad(out, lambda g: _replicate_uneven(g, d, shape[d]))


def grad_as_value(t):
    """`t`, whose gradient reaches it laid out as `t` itself is (a DTensor
    used twice, as a tied embedding, then sums two gradients of one
    layout)."""
    if not is_dt(t):
        return t
    placements = t.placements
    return _on_grad(t, lambda g: g.redistribute(g.device_mesh, placements))


def reduced(t):
    """DTensor `t` with every partial placement reduced (replicated); a
    plain tensor as it is."""
    if not is_dt(t):
        return t
    from torch.distributed.tensor import Replicate, Shard
    pl = [p if isinstance(p, (Shard, Replicate)) else Replicate()
          for p in t.placements]
    if pl == list(t.placements):
        return t
    return t.redistribute(t.device_mesh, pl)


def keep(t, dims=(0,)):
    """The placements of DTensor `t` that shard one of `dims`, every other
    mesh dim replicated."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(p if isinstance(p, Shard) and p.dim % t.ndim in dims
                 else Replicate() for p in t.placements)


def batch_placements(t, rows: int, claimed=()) -> tuple:
    """Placements on DTensor `t`'s mesh that shard dim 0 (the batch,
    `rows` long) over the "pod" and "data" mesh dims, and over any other
    mesh dim that already shards it, wherever the rows divide evenly
    (taken over the mesh dims in order); every other mesh dim replicated.
    The mesh dims in `claimed` are left None for the caller."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = t.device_mesh
    names = mesh.mesh_dim_names or ()
    out, split = [], 1
    for i, p in enumerate(t.placements):
        n = mesh.size(i)
        dp = i < len(names) and names[i] in ("pod", "data")
        if i in claimed:
            out.append(None)
        elif (dp or isinstance(p, Shard) and p.dim % t.ndim == 0) \
                and rows % (split * n) == 0:
            out.append(Shard(0))
            split *= n
        else:
            out.append(Replicate())
    return tuple(out)


def replicated(mesh):
    from torch.distributed.tensor import Replicate
    return (Replicate(),) * mesh.ndim


def local(fn, out_placements, in_placements, *args, in_grad_placements=None):
    """fn(*args) on every rank's local shards: each DTensor argument is
    redistributed to its entry of `in_placements` (None: not a DTensor),
    and each output becomes a DTensor of its `out_placements` entry
    (`in_grad_placements`: the placements of the inputs' gradients, when
    they are not the inputs' own).  On plain tensors, fn(*args)."""
    mesh = mesh_of(*args)
    if mesh is None:
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map
    return local_map(fn, out_placements=out_placements,
                     in_placements=in_placements,
                     in_grad_placements=in_grad_placements,
                     device_mesh=mesh, redistribute_inputs=True)(*args)

