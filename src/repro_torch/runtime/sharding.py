"""Sharding rules: DP / TP (Megatron-style) / EP / FSDP as partition specs
(port of `repro.runtime.sharding`), placed with DTensor.

Axis->fabric-tier mapping (the paper's Eq. (3) load-balance transposed to
ML collectives):
  "model" -> on-wafer C-group links  (TP/EP collectives, highest volume)
  "data"  -> intra-W-group local links (gradient reduction)
  "pod"   -> global links (rare cross-pod sync, compressed)

Every rule takes a mesh as any object with the reference's `axis_names`
and a `shape` mapping from axis name to size, so the reference's
`FakeMesh` works as is; a `torch.distributed` `DeviceMesh` goes through
`MeshAxes`.  A spec is a `PartitionSpec`: one entry a tensor dim, each
None, an axis name or a tuple of axis names.

The port's parameters are un-stacked (``blocks.<g>.sub0.mix.q.w``);
the reference's carry a leading group (or encoder layer) dim
(``blocks/sub0/mix/q/w``) that is never sharded.  `tree_param_specs`
maps each name to the reference's path by `models.convert`'s rule and
applies the reference's rule to the logical shape, so a port spec is the
reference's without its leading None.  Caches keep the reference's
stacked layout, so `cache_specs` follows the reference one to one.
"""
from __future__ import annotations

import numpy as np
import torch

# the reference's param subtrees stacked with a leading axis (the same
# tuple as `models.convert.STACKED`)
STACKED = ("blocks", "encoder")


class PartitionSpec(tuple):
    """One entry a tensor dim: None (replicated), an axis name, or a tuple
    of axis names (the dim split over their product, major first)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


class MeshAxes:
    """A `DeviceMesh` seen as the rules see a mesh: `axis_names` and a
    `shape` mapping (the reference's `Mesh.shape`)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.axis_names = tuple(mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, mesh.mesh.shape))


def _axes(mesh):
    return mesh if hasattr(mesh, "axis_names") else MeshAxes(mesh)


def dp_axes(mesh):
    mesh = _axes(mesh)
    axes = tuple(a for a in mesh.axis_names if a in ("pod", "data"))
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def _axis_size(mesh, name: str) -> int:
    return _axes(mesh).shape.get(name, 1)


def param_spec(path: tuple, shape: tuple, mesh,
               fsdp_threshold: int = 1 << 22) -> P:
    """The reference's rule for one parameter, on the reference's `path`
    (tuple of tree keys) and `shape`: a ``blocks/`` or ``encoder/`` leaf
    carries a leading stacked dim that is never sharded."""
    mp = _axis_size(mesh, "model")
    dsize = _axis_size(mesh, "data")
    name = "/".join(str(k) for k in path)
    nd = len(shape)
    spec = [None] * nd
    off = 1 if name.startswith("blocks/") or name.startswith("encoder/") \
        else 0

    def logical(i):
        return off + i

    ls = tuple(shape[off:])
    lnd = len(ls)

    if name.endswith("embed") or "lm_head" in name:
        # vocab-parallel embedding / output head
        vdim = 0 if name.endswith("embed") else 1
        if _div(ls[vdim], mp):
            spec[logical(vdim)] = "model"
        other = 1 - vdim
        if _div(ls[other], dsize) and np.prod(ls) > fsdp_threshold:
            spec[logical(other)] = "data"
    elif "router" in name:
        pass  # replicated
    elif lnd == 3:  # stacked experts [E, din, dout]
        if _div(ls[0], mp):
            spec[logical(0)] = "model"      # expert parallelism
            if _div(ls[1], dsize) and np.prod(ls) > fsdp_threshold:
                spec[logical(1)] = "data"   # FSDP within expert
        elif _div(ls[2], mp):
            spec[logical(2)] = "model"
    elif lnd == 2:
        din, dout = ls
        col_parallel = any(s in name for s in (
            "/q/", "/k/", "/v/", "wi", "wg", "in_x", "in_gate", "in_proj",
            "w_a", "w_x"))
        row_parallel = any(s in name for s in (
            "/o/", "wo", "out", "out_proj"))
        if col_parallel and _div(dout, mp):
            spec[logical(1)] = "model"
            if _div(din, dsize) and np.prod(ls) > fsdp_threshold:
                spec[logical(0)] = "data"
        elif row_parallel and _div(din, mp):
            spec[logical(0)] = "model"
            if _div(dout, dsize) and np.prod(ls) > fsdp_threshold:
                spec[logical(1)] = "data"
        elif _div(dout, mp):
            spec[logical(1)] = "model"
        elif _div(din, mp):
            spec[logical(0)] = "model"
    # 1D (biases, norm scales, A_log, conv) stay replicated
    return P(*spec)


def reference_path(name: str) -> tuple[tuple, bool]:
    """(the reference's tree path, stacked) of the port's parameter `name`:
    ``blocks.<g>.sub0.mix.q.w`` is ``("blocks", "sub0", "mix", "q", "w")``
    with a leading group dim (`models.convert._leaf_of`)."""
    parts = tuple(name.split("."))
    if parts[0] in STACKED:
        return (parts[0],) + parts[2:], True
    return parts, False


def tree_param_specs(named, mesh, **kw) -> dict:
    """name -> spec for `named` (a module, or name -> tensor with the
    port's parameter names; tensors on any device, `meta` included)."""
    if hasattr(named, "named_parameters"):
        named = dict(named.named_parameters())
    out = {}
    for name, t in named.items():
        path, stacked = reference_path(name)
        shape = ((1,) if stacked else ()) + tuple(t.shape)
        spec = param_spec(path, shape, mesh, **kw)
        out[name] = P(*spec[1:]) if stacked else spec
    return out


def opt_state_specs(param_specs: dict, named, mesh) -> dict:
    """ZeRO: optimizer moments reuse the param spec and additionally shard
    the first unsharded divisible dim over "data"."""
    if hasattr(named, "named_parameters"):
        named = dict(named.named_parameters())
    dsize = _axis_size(mesh, "data")

    def extend(spec, shape):
        parts = list(spec) + [None] * (len(shape) - len(spec))
        if "data" in parts:
            return P(*parts)
        for i, (p, s) in enumerate(zip(parts, shape)):
            if p is None and _div(s, dsize) and s >= dsize:
                parts[i] = "data"
                return P(*parts)
        return P(*parts)

    return {n: extend(param_specs[n], tuple(named[n].shape))
            for n in param_specs}


def opt_specs(param_specs: dict, named, mesh) -> dict:
    """The whole AdamW state's specs, keyed as `init_opt_state`'s tree."""
    os_ = opt_state_specs(param_specs, named, mesh)
    return {"master": os_, "m": dict(os_), "v": dict(os_), "step": P()}


def _dp_size(mesh) -> int:
    n = 1
    for a in ("pod", "data"):
        n *= _axis_size(mesh, a)
    return n


def batch_specs(batch_shapes: dict, mesh) -> dict:
    dp = dp_axes(mesh)
    n = _dp_size(mesh)
    out = {}
    for k, v in batch_shapes.items():
        shape = tuple(v.shape)
        lead = dp if shape and _div(shape[0], n) else None
        spec = [lead] + [None] * (len(shape) - 1)
        # batch-1 long-context: shard the sequence dim over data instead
        if lead is None and len(shape) >= 2 and _div(shape[1], n) \
                and shape[1] >= n:
            spec[1] = dp
        out[k] = P(*spec)
    return out


def _tree_leaves(tree, path=()):
    """(path, leaf) of a tree of dicts, lists and tuples; a
    `PartitionSpec` is a leaf."""
    if isinstance(tree, PartitionSpec):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tree_leaves(v, path + (i,))
    else:
        yield path, tree


def _tree_map(fn, tree, path=()):
    if isinstance(tree, PartitionSpec):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def cache_specs(cache, mesh):
    """KV/state caches: batch-sharded; KV heads sharded over model when
    divisible.  `cache` is `transformer.init_cache`'s tree; the result is
    the same tree of specs."""
    dp = dp_axes(mesh)
    mp = _axis_size(mesh, "model")
    n = _dp_size(mesh)

    def one(path, leaf):
        shape = tuple(leaf.shape)
        stacked = "blocks" in path
        if len(shape) == 0 or (len(shape) == 1 and stacked):
            return P(*([None] * len(shape)))   # scalars (idx) replicated
        off = 1 if stacked else 0
        spec = [None] * len(shape)
        if len(shape) - off == 0:
            return P(*spec)
        if len(shape) - off >= 1 and _div(shape[off], n):
            spec[off] = dp          # batch dim
        # kv cache [B, W, KV, hd]: shard KV heads over model if divisible,
        # otherwise shard the window (sequence) dim
        if len(shape) - off == 4:
            if _div(shape[off + 2], mp):
                spec[off + 2] = "model"
            elif _div(shape[off + 1], mp) and shape[off + 1] >= 4 * mp:
                spec[off + 1] = "model"
        return P(*spec)

    return _tree_map(one, cache)


# --- placement ---------------------------------------------------------------

def placements(spec, mesh) -> tuple:
    """DTensor placements of `spec` on the `DeviceMesh` `mesh`: a mesh dim
    named in the spec's entry for tensor dim d is ``Shard(d)``, every
    other mesh dim ``Replicate()``.  A tuple entry shards dim d over its
    axes in order, major first, as the reference's mesh does."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry,) if isinstance(entry, str) else entry:
            out[names.index(a)] = Shard(d)
    return tuple(out)


def shardings(tree_specs, mesh):
    """The placements of every spec of `tree_specs` (a dict / list tree of
    `PartitionSpec`s) on `mesh`."""
    return _tree_map(lambda _p, s: placements(s, mesh), tree_specs)


def distribute(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """`t` (the full tensor, the same on every rank) as a DTensor of
    `spec` on `mesh`; a DTensor is redistributed to it."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    pl = placements(spec, mesh)
    if isinstance(t, DTensor):
        return t.redistribute(mesh, pl)
    # every rank holds the same full tensor: each keeps its shard, and
    # nothing is sent
    return distribute_tensor(t, mesh, pl, src_data_rank=None)


def make_constrain(mesh, seq_parallel: bool = True):
    """Activation constraint closure passed into the model: batch over the
    data axes and - Megatron sequence parallelism - the sequence dim over
    "model" for the residual stream.  On a DTensor it redistributes to
    the spec; a plain tensor (or a rank other than 3) passes through."""
    dp = dp_axes(mesh)
    mp = _axis_size(mesh, "model")

    def spec_of(x, kind: str = "resid"):
        if kind == "logits":
            return P(dp, None, "model") if x.shape[2] % mp == 0 \
                else P(dp, None, None)
        if kind == "gather":      # replicate features, batch-shard only
            return P(dp, None, None)
        if seq_parallel and x.shape[1] % mp == 0 and x.shape[1] >= mp:
            return P(dp, "model", None)
        return P(dp, None, None)

    def constrain(x, kind: str = "resid"):
        from torch.distributed.tensor import DTensor
        if x.ndim != 3 or not isinstance(x, DTensor):
            return x
        return x.redistribute(x.device_mesh,
                              placements(spec_of(x, kind), x.device_mesh))

    constrain.spec_of = spec_of
    return constrain
