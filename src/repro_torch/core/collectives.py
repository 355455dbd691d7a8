"""Topology-aware collectives: the paper's AllReduce schedules (Sec. III-B4,
Fig. 4, Fig. 14) on `torch.distributed` (port of
`repro.core.collectives`).

Three layers:
  * `ring_all_reduce` / `bidir_ring_all_reduce` - explicit ring schedules
    of point-to-point steps (`batch_isend_irecv`, the Fig. 14
    algorithms).  The bidirectional variant halves the message and pushes
    the halves in opposite directions, which on the wafer fabric doubles
    effective injection (the paper's 4-ports-per-chip argument).
  * `hierarchical_psum` - reduce-scatter on the on-wafer axis, cross-wafer
    all-reduce on the scattered shards, all-gather back (Fig. 4(b)
    transposed to mesh axes).
  * `psum_2d` - 2D algorithm over two mesh axes (row phase then column
    phase), the O(sqrt(N)) schedule of Fig. 4(b).

Where the reference binds a named axis inside `shard_map`, every
function here takes ``(x, mesh, axis_name)``: `x` is this rank's block,
`mesh` a `DeviceMesh` and the axis one of its dim names; the group is
``mesh.get_group(axis_name)`` and the rank's position on it
``mesh.get_local_rank(axis_name)``.  Every rank of the mesh calls the
function.  The ring keeps the reference's step order, chunk positions
and padding, so each chunk's terms are added in the same order.  The
group collectives are the functional ones (`_functional_collectives`),
each waited on before its result is read.  `runtime.hlo_analysis.
record_collectives` sees those as they dispatch; the ring's
point-to-point steps report themselves to it (`note`).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F


def _note(op: str, x, ranks) -> None:
    from ..runtime.hlo_analysis import note
    note(op, x.numel() * x.element_size(), ranks)


def _axis(mesh, axis_name: str):
    """(group, size, this rank's index on the axis, the axis' global
    ranks in order)."""
    group = mesh.get_group(axis_name)
    ranks = dist.get_process_group_ranks(group)
    return group, len(ranks), mesh.get_local_rank(axis_name), ranks


def _pad_rows(x, n):
    pad = (-x.shape[0]) % n
    if pad:
        x = F.pad(x, [0, 0] * (x.ndim - 1) + [0, pad])
    return x, pad


def _permute(send, ranks, idx, step):
    """One ppermute step: send to position idx + step, receive from
    idx - step on the ring `ranks`."""
    n = len(ranks)
    recv = torch.empty_like(send)
    src, dst = ranks[(idx - step) % n], ranks[(idx + step) % n]
    # the op's first (source, target) pair, which the reference's
    # accounting classifies the permute by
    _note("collective-permute", send, (ranks[0], ranks[step % n]))
    ops = [dist.P2POp(dist.isend, send.contiguous(), dst),
           dist.P2POp(dist.irecv, recv, src)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return recv


def ring_all_reduce(x: torch.Tensor, mesh, axis_name: str):
    """Unidirectional ring allreduce (reduce-scatter + all-gather), 2(n-1)
    steps, each moving |x|/n bytes per link."""
    _, n, idx, ranks = _axis(mesh, axis_name)
    if n == 1:
        return x
    xp, pad = _pad_rows(x, n)
    chunks = xp.reshape(n, -1, *xp.shape[1:])

    # reduce-scatter: n-1 steps; after step n-1 this rank holds the fully
    # reduced chunk at position (idx + 1) % n
    acc = None
    send = chunks[idx]
    for i in range(1, n):
        recv = _permute(send, ranks, idx, 1)
        pos = (idx - i + n) % n
        if i < n - 1:
            send = recv + chunks[pos]
        else:
            acc = recv + chunks[pos]
    # all-gather: circulate the reduced chunk n-1 more steps
    out_chunks = torch.zeros_like(chunks)
    out_chunks[(idx - (n - 1) + n) % n] = acc
    send = acc
    for i in range(n - 1):
        recv = _permute(send, ranks, idx, 1)
        out_chunks[(idx - (n - 1) - (i + 1)) % n] = recv
        send = recv
    y = out_chunks.reshape(-1, *xp.shape[1:])
    return y[:x.shape[0]] if pad else y


def _ring_all_reduce_rev(x: torch.Tensor, mesh, axis_name: str):
    _, n, idx, ranks = _axis(mesh, axis_name)
    xp, pad = _pad_rows(x, n)
    chunks = xp.reshape(n, -1, *xp.shape[1:])
    acc = None
    send = chunks[idx]
    for i in range(1, n):
        recv = _permute(send, ranks, idx, -1)
        pos = (idx + i) % n
        if i < n - 1:
            send = recv + chunks[pos]
        else:
            acc = recv + chunks[pos]
    # acc = fully reduced chunk (idx - 1) % n
    out_chunks = torch.zeros_like(chunks)
    out_chunks[(idx - 1) % n] = acc
    send = acc
    for i in range(n - 1):
        recv = _permute(send, ranks, idx, -1)
        out_chunks[(idx + i) % n] = recv
        send = recv
    y = out_chunks.reshape(-1, *xp.shape[1:])
    return y[:x.shape[0]] if pad else y


def bidir_ring_all_reduce(x: torch.Tensor, mesh, axis_name: str):
    """Bidirectional ring: halves travel in opposite directions (Fig. 14)."""
    _, n, _, _ = _axis(mesh, axis_name)
    if n == 1:
        return x
    half = x.shape[0] // 2
    y1 = ring_all_reduce(x[:half], mesh, axis_name)
    # reverse direction: the ring walked the other way
    y2 = _ring_all_reduce_rev(x[half:], mesh, axis_name)
    return torch.cat([y1, y2], dim=0)


def _group_of(mesh, axes):
    """The process group over one mesh axis, or over several together
    (this rank's slice of the mesh along them)."""
    if isinstance(axes, str):
        return mesh.get_group(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[tuple(axes)]._flatten().get_group()


def _functional():
    import torch.distributed._functional_collectives as funcol
    return funcol


def reduce_scatter(x: torch.Tensor, mesh, axis_name: str):
    """Sum over the axis, this rank keeping its 1/n block of rows."""
    group = _group_of(mesh, axis_name)
    funcol = _functional()
    return funcol.wait_tensor(funcol.reduce_scatter_tensor(
        x.contiguous(), "sum", 0, group))


def all_gather(x: torch.Tensor, mesh, axis_name: str):
    """The axis' blocks stacked along rows, in rank order."""
    group = _group_of(mesh, axis_name)
    funcol = _functional()
    return funcol.wait_tensor(funcol.all_gather_tensor(
        x.contiguous(), 0, group))


def all_reduce(x: torch.Tensor, mesh, axes, op: str = "sum"):
    """Sum (or max) over one mesh axis or a tuple of them."""
    group = _group_of(mesh, axes)
    funcol = _functional()
    return funcol.wait_tensor(funcol.all_reduce(x.contiguous(), op, group))


def hierarchical_psum(x: torch.Tensor, mesh, wafer_axis: str, cross_axes):
    """Reduce-scatter on-wafer -> cross-wafer all-reduce -> all-gather
    on-wafer.  The heavy 2(n-1)/n traffic stays on the on-wafer tier; the
    cross-wafer tier moves only 1/n of the bytes per device."""
    if isinstance(cross_axes, str):
        cross_axes = (cross_axes,)
    n = mesh.size(mesh.mesh_dim_names.index(wafer_axis))
    orig = x.shape[0]
    x, pad = _pad_rows(x, n)
    s = reduce_scatter(x, mesh, wafer_axis)
    s = all_reduce(s, mesh, tuple(cross_axes))
    y = all_gather(s, mesh, wafer_axis)
    return y[:orig] if pad else y


def psum_2d(x: torch.Tensor, mesh, row_axis: str, col_axis: str):
    """Fig. 4(b): 2D algorithm - reduce along rows then columns, scattered,
    then gather back; latency O(sqrt(N)) instead of O(N)."""
    n = mesh.size(mesh.mesh_dim_names.index(row_axis))
    orig = x.shape[0]
    x, pad = _pad_rows(x, n)
    s = reduce_scatter(x, mesh, row_axis)
    s = all_reduce(s, mesh, col_axis)
    y = all_gather(s, mesh, row_axis)
    return y[:orig] if pad else y
