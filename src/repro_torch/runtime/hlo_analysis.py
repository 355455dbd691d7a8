"""Collective accounting of a traced step (port of
`repro.runtime.hlo_analysis`, whose name it keeps).

The reference regexes the optimized HLO text for every all-gather /
all-reduce / reduce-scatter / all-to-all / collective-permute, sums the
operand sizes and attributes each op to a mesh axis by the stride
pattern of its replica groups.  The port has no HLO: it records the
collectives a step issues while it runs.  `record_collectives()` is a
context whose dispatch mode sees the ``torch.ops._c10d_functional``
collectives that DTensor issues (and the port's own
`core/collectives.py` calls, which report themselves through
`note`); each becomes ``{"op", "bytes", "ranks"}``: the reference's op
name, the bytes of its operands on this rank, and the global ranks of
its group.  `classify_groups` is the reference's replica-group
classifier on such a rank list, and `collective_bytes` its totals.

The port's layers are a Python loop, so every collective is recorded
each time it runs: there is no loop-trip scaling (the reference scales
ops inside `while` bodies by `loop_trips`), and every op's `mult` is 1.
"""
from __future__ import annotations

from collections import defaultdict
from contextlib import contextmanager

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter",
                  "all-to-all", "collective-permute")

# ``_c10d_functional`` op -> (the reference's name, index of the group
# name among the op's arguments)
_FUNCTIONAL = {
    "all_gather_into_tensor": ("all-gather", 2),
    "all_gather_into_tensor_coalesced": ("all-gather", 2),
    "all_reduce": ("all-reduce", 2),
    "all_reduce_coalesced": ("all-reduce", 2),
    "reduce_scatter_tensor": ("reduce-scatter", 3),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", 3),
    "all_to_all_single": ("all-to-all", 3),
    "broadcast": ("all-gather", 2),
}

_RECORDERS: list = []


def group_ranks(group) -> list:
    """The global ranks of a process group, or of a group name as the
    functional collectives carry it."""
    import torch.distributed as dist
    if isinstance(group, str):
        from torch.distributed.distributed_c10d import _resolve_process_group
        group = _resolve_process_group(group)
    return list(dist.get_process_group_ranks(group))


def _bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_bytes(t) for t in x)
    return 0


def note(op: str, nbytes: int, ranks) -> None:
    """Record one collective in every open `record_collectives` (the port's
    own collectives call this; DTensor's are seen by the mode)."""
    for rec in _RECORDERS:
        rec.append({"op": op, "bytes": int(nbytes), "ranks": list(ranks)})


class _Recorder(TorchDispatchMode):
    def __init__(self, records: list):
        super().__init__()
        self.records = records

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "_c10d_functional":
            name = func._overloadpacket.__name__
            if name in _FUNCTIONAL:
                op, gi = _FUNCTIONAL[name]
                group = args[gi] if len(args) > gi else kwargs.get(
                    "group_name")
                self.records.append({"op": op, "bytes": _bytes(args[0]),
                                     "ranks": group_ranks(group)})
        return func(*args, **kwargs)


@contextmanager
def record_collectives():
    """Yields the list that collects one record a collective issued inside
    the context (on this rank)."""
    records: list = []
    _RECORDERS.append(records)
    try:
        with _Recorder(records):
            yield records
    finally:
        _RECORDERS.remove(records)


def _strides(axis_sizes: dict) -> dict:
    strides, s = {}, 1
    for a in reversed(list(axis_sizes)):
        strides[a] = s
        s *= axis_sizes[a]
    return strides


def classify_groups(ranks, axis_sizes: dict) -> str:
    """The mesh-axis label of a group of global ranks (the reference's
    `_classify_groups` on a rank list): "none" for one rank, an axis name,
    contiguous axes joined by "+", or "mixed".

    axis_sizes: ordered {axis: size} major-to-minor, e.g.
    {"pod": 2, "data": 16, "model": 16} -> rank = pod*256 + data*16 +
    model."""
    group = sorted(int(r) for r in ranks)
    names = list(axis_sizes)
    strides = _strides(axis_sizes)
    if len(group) <= 1:
        return "none"
    d = group[1] - group[0]
    for a in names:
        if d == strides[a] and len(group) == axis_sizes[a] and \
           all(group[i + 1] - group[i] == d for i in range(len(group) - 1)):
            return a
    # combined axes (e.g. data+model = contiguous block)
    span = group[-1] - group[0] + 1
    if span == len(group):
        combo, prod = [], 1
        for a in reversed(names):
            combo.append(a)
            prod *= axis_sizes[a]
            if prod == len(group):
                return "+".join(reversed(combo))
    return "mixed"


def classify_pair(pair, axis_sizes: dict) -> str:
    """The axis of a collective-permute's (source, target) pair: the axis
    whose stride is their distance, else "mixed" (the reference's
    `source_target_pairs` rule)."""
    d = abs(int(pair[1]) - int(pair[0]))
    for a, st in _strides(axis_sizes).items():
        if d == st:
            return a
    return "mixed"


def collective_bytes(records, axis_sizes: dict) -> dict:
    """{"by_op", "by_axis", "ops"}: the bytes of `records` summed by op
    and by the axis `classify_groups` gives their ranks (a
    collective-permute's ranks are its (source, target) pair); every
    op's `mult` is 1."""
    by_op = defaultdict(int)
    by_axis = defaultdict(int)
    ops = []
    for r in records:
        if r["op"] == "collective-permute":
            axis = classify_pair(r["ranks"], axis_sizes)
        else:
            axis = classify_groups(r["ranks"], axis_sizes)
        by_op[r["op"]] += r["bytes"]
        by_axis[axis] += r["bytes"]
        ops.append({"op": r["op"], "bytes": r["bytes"], "axis": axis,
                    "mult": 1})
    return {"by_op": dict(by_op), "by_axis": dict(by_axis), "ops": ops}
