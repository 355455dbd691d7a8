"""Plain PyTorch versions of the netsim kernels.

`grant_ref` is the port of `repro.kernels.netsim.ref.grant_ref`: the
two-pass age-based arbitration (`scatter_reduce_(..., "amin")` from an
INF32 fill, twice).  `cycle_core_ref` is the plain form of the
reference's `cycle_core` (`repro.kernels.netsim.ops`), which has no
`ref` of its own there: one `scatter_reduce_` of a 64-bit packed key.
Both take raw tensors with an optional leading lane dimension; they are
the CPU path of `ops` and the references the CUDA kernels are held to.
Integer keys and exact min/tie-break semantics make "bit-identical"
well-defined.  `head_records_dense_ref` and `head_records_picked_ref` are
the fused step's record gathers as `take` / `lane_take` expressions.
"""
from __future__ import annotations

import torch

from ...tensors import lane_take, take

INF32 = 2**31 - 1
INF64 = 2**63 - 1


def grant_ref(out, itime, valid, ovc_count, is_eject, ch_busy, ch_alive,
              *, buf_pkts: int):
    """One winner per output channel, oldest `itime` first, row ids break
    ties.

    out        [B?, N] int32  requested output channel (-1 = stranded,
                              never granted)
    itime      [B?, N] int32  generation cycle (age key)
    valid      [B?, N] bool   the row holds a forwardable packet
    ovc_count  [B?, N] int32  occupancy of the requested downstream buffer
    is_eject   [B?, N] bool   the requested channel is an ejection channel
                              (always has credit)
    ch_busy    [B?, E] int32  per-channel serialization countdown
    ch_alive   [B?, E] bool   per-channel fault mask

    Returns (win [B?, N] bool, won_ch [B?, E] bool).
    """
    if out.dim() == 1:
        win, won = grant_ref(out[None], itime[None], valid[None],
                             ovc_count[None], is_eject[None], ch_busy[None],
                             ch_alive[None], buf_pkts=buf_pkts)
        return win[0], won[0]
    B, N = out.shape
    E = ch_busy.shape[-1]
    credit = ovc_count < buf_pkts
    ok = valid & (out >= 0) & (lane_take(ch_busy, out) == 0) \
        & (credit | is_eject)
    ok = ok & lane_take(ch_alive, out)

    seg = torch.where(ok, out, E).long()
    fill = torch.full((B, E + 1), INF32, dtype=torch.int32, device=out.device)
    key1 = torch.where(ok, itime, INF32)
    m1 = fill.clone().scatter_reduce_(1, seg, key1, "amin")
    tie = ok & (itime == lane_take(m1, out))
    ridx = torch.arange(N, dtype=torch.int32, device=out.device).expand(B, N)
    key2 = torch.where(tie, ridx, INF32)
    m2 = fill.scatter_reduce_(1, seg, key2, "amin")
    win = tie & (ridx == lane_take(m2, out))
    won_ch = m1[:, :E] != INF32
    return win, won_ch


def check_r2(r2: int, rows: int, prio) -> None:
    """The reference's `r2` contract, kept so that callers carry over: a
    power of two above every priority.  Only `prio` is checked against it
    (the row iota when `prio` is None; explicit priorities on the CPU,
    where reading them costs no device synchronisation)."""
    r2 = int(r2)
    if r2 < 1 or r2 & (r2 - 1):
        raise ValueError(f"cycle_core: r2 must be a power of two, got {r2}")
    if prio is None:
        top = rows - 1
    elif prio.device.type == "cpu" and prio.numel():
        top = int(prio.max())
    else:
        return
    if top >= r2:
        raise ValueError(f"cycle_core: priority {top} does not fit below "
                         f"r2 = {r2}")


def cycle_core_ref(out, itime, ok, ch_ok, *, r2: int, prio=None):
    """The fused and compact steps' arbitration core: one winner per
    output channel, the minimum of the key ``(itime, prio)`` over the
    `ok` rows, with the channel mask applied after the reduction.

    out    [B?, N] int32  requested output channel (rows outside [0, E)
                          are never granted)
    itime  [B?, N] int32  generation cycle (age key)
    ok     [B?, N] bool   the row is eligible (valid, routable, credit)
    ch_ok  [B?, E] bool   the channel may grant (not busy, alive)
    prio   [B?, N] int32  tie-break priority, non-negative and unique over
                          the ok rows; None means the row index

    Returns (won_ch [B?, E] bool, wprio [B?, E] int32 — the winner's
    priority, 0 where no winner — and win [B?, N] bool, the pop mask).

    The key is built in int64 as ``(itime << 32) | prio``, so it equals
    the reference's packed int32 key ``itime * r2 + prio`` wherever that
    fits and its two-pass age-then-priority form everywhere else."""
    if out.dim() == 1:
        won, wprio, win = cycle_core_ref(
            out[None], itime[None], ok[None], ch_ok[None], r2=r2,
            prio=None if prio is None else prio[None])
        return won[0], wprio[0], win[0]
    B, N = out.shape
    E = ch_ok.shape[-1]
    check_r2(r2, N, prio)
    if prio is None:
        prio = torch.arange(N, dtype=torch.int32,
                            device=out.device).expand(B, N)
    ok = ok & (out >= 0) & (out < E)
    key = (itime.long() << 32) | prio.long()
    seg = torch.where(ok, out, E).long()
    m = torch.full((B, E + 1), INF64, dtype=torch.int64, device=out.device)
    m.scatter_reduce_(1, seg, torch.where(ok, key, INF64), "amin")
    m = torch.where(ch_ok, m[:, :E], INF64)
    won = m != INF64
    wprio = torch.where(won, m & 0xFFFFFFFF, 0).to(torch.int32)
    win = ok & (lane_take(m, out) == key)
    return won, wprio, win


def head_records_dense_ref(store, b_head, rows: int):
    """The buffer-head record of each (lane, channel, VC) of the first
    `rows` channels: ``head[b, e * NV + v] = store[b, e, v, b_head[b, e,
    v]]``.

    store   [B, E', NV, S, F]  the buffered records (E' >= rows; the
                               state's ``b_pkt`` with its spare row)
    b_head  [B, E'', NV] int   the head slot of each buffer, in [0, S)
                               (E'' >= rows)

    Returns head [B, rows * NV, F]."""
    B, NV = store.shape[0], store.shape[2]
    dev = store.device
    lane = torch.arange(B, device=dev).view(B, 1, 1)
    e = torch.arange(rows, device=dev).view(1, rows, 1)
    v = torch.arange(NV, device=dev).view(1, 1, NV)
    return take(store, lane, e, v, b_head[:, :rows], clamp=False).reshape(
        B, rows * NV, -1)


def head_records_picked_ref(head, idx):
    """The records ``head[b, idx[b, c]]`` (head [B, R, F], idx [B, E]),
    with the reference's gather rule: a negative index wraps once, then
    is clamped to [0, R - 1].  Returns [B, E, F]."""
    return lane_take(head, idx)
