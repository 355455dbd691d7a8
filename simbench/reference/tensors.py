"""Tensor helpers shared by the routing kernels and the engine phases.

The reference gathers with JAX semantics: a negative index wraps once
(``-1`` is the last entry) and an index still out of range is CLAMPED to
the nearest end.  The engine relies on that for rows that hold no packet
(their stale routing fields may request a VC class past the last VC) and
for stranded rows (``out = -1``).  PyTorch raises on such an index, or
device-asserts on CUDA, so every data-dependent gather goes through
`take` / `lane_take`, which reproduce the reference semantics exactly.

Gathers and scatters go through one flat row index and
`index_select` / `index_copy_` / `index_add_`, which are several times
cheaper than multi-tensor advanced indexing.

Lane convention: engine tensors carry a leading lane dimension ``B`` (the
reference's `vmap` axis).  Per-lane tables (the `fl` dict) are ``[B, ...]``
and are indexed with `lane_take`; static tables (closed over by the route
kernels) have no lane dimension and are indexed with `take`.
"""
from __future__ import annotations

import numpy as np
import torch


def as_tensor(x, device) -> torch.Tensor:
    """numpy -> device tensor with the reference's 32-bit dtypes (JAX runs
    with 64-bit mode off: integers become int32, floats float32)."""
    a = np.asarray(x)
    if a.dtype == np.bool_:
        dtype = torch.bool
    elif np.issubdtype(a.dtype, np.integer):
        dtype = torch.int32
    else:
        dtype = torch.float32
    return torch.as_tensor(a).to(device=device, dtype=dtype)


def clamp_index(i, n: int):
    """JAX gather index semantics: wrap a negative index once, then clamp
    to ``[0, n-1]`` (``clamp(-n, n-1) % n`` is exactly that)."""
    return i.clamp(-n, n - 1) % n


def flat_index(shape, idx, clamp: bool = True):
    """Row-major flat index of ``tbl[idx0, idx1, ...]`` over the leading
    ``len(idx)`` dims of `shape` (broadcast over the index tensors)."""
    flat = None
    for d, i in enumerate(idx):
        if clamp:
            i = clamp_index(i, shape[d])
        flat = i if flat is None else flat * shape[d] + i
    return flat


def take_flat(tbl: torch.Tensor, k: int, flat: torch.Tensor):
    """Rows of `tbl` (leading `k` dims flattened) at the flat index."""
    rest = tuple(tbl.shape[k:])
    out = tbl.reshape((-1,) + rest).index_select(0, flat.reshape(-1))
    return out.view(tuple(flat.shape) + rest)


def take(tbl: torch.Tensor, *idx, clamp: bool = True):
    """``tbl[idx0, idx1, ...]`` with the reference's out-of-range rules
    (`clamp=False` only where every index is known to be in range)."""
    return take_flat(tbl, len(idx), flat_index(tbl.shape, idx, clamp))


def lane_index(tbl: torch.Tensor, idx) -> torch.Tensor:
    """Flat index of the per-lane gather ``tbl[b, idx0[b], ...]`` over a
    lane-stacked ``tbl [B, ...]`` (index tensors carry the lane dim or
    broadcast against it)."""
    B = tbl.shape[0]
    nd = max(i.dim() for i in idx)
    lane = torch.arange(B, device=tbl.device).view((B,) + (1,) * (nd - 1))
    return lane * int(np.prod(tbl.shape[1:len(idx) + 1])) \
        + flat_index(tbl.shape[1:], idx)


def lane_take(tbl: torch.Tensor, *idx):
    """Per-lane gather ``tbl[b, idx0[b, ...], ...]`` for a lane-stacked
    table ``[B, ...]``; a table shared by every lane (a stride-0 view, see
    `routing.share_lanes`) is gathered once, without the lane index."""
    if tbl.stride(0) == 0:
        return take(tbl[0], *idx)
    return take_flat(tbl, len(idx) + 1, lane_index(tbl, idx))


def to_device(v: torch.Tensor, device) -> torch.Tensor:
    """`v` on `device` (itself when it is there already); a tensor shared
    over its leading dim (a stride-0 view, `routing.share_lanes`) moves
    one row and stays a stride-0 view."""
    if v.dim() > 0 and v.shape[0] > 1 and v.stride(0) == 0:
        return v[:1].to(device).expand(v.shape)
    return v.to(device)
