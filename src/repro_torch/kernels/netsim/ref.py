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
`threefry_split_ref`, `threefry_bits_ref`, `threefry_uniform_ref`,
`threefry_randint_ref` and `threefry_bernoulli_ref` are the draws of the
port's PRNG (`repro_torch.random`), `threefry2x32` run as int64 tensor
operations masked to 32 bits; `threefry_chain_ref` is a dispatch's
per-cycle subkey chain, one `threefry_split_ref` a cycle.
"""
from __future__ import annotations

import math

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


# ---- Threefry-2x32, the PRNG's hash ------------------------------------

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k1, k2, x0, x1):
    """The Threefry-2x32 hash (20 rounds) on broadcastable int64 tensors
    of uint32 words; returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def _hash(key: torch.Tensor, shape: tuple):
    """Threefry over the flat iota of `shape` (hi/lo count words), keyed
    per leading batch entry of `key`; returns both output words."""
    n = math.prod(shape)
    lo = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    hi = lo >> 32
    bshape = key.shape[:-1] + (1,) * len(shape)
    k1 = key[..., 0].reshape(bshape)
    k2 = key[..., 1].reshape(bshape)
    return threefry2x32(k1, k2, hi, lo)


def randint_span(minval: int, maxval: int) -> tuple[int, int]:
    """`randint`'s span and multiplier (uint32 values): the span 1 for an
    empty range, and ``(2^16 mod span)^2 mod span``, with which two 32-bit
    draws combine into one below the span."""
    if not (-2**31 <= minval and maxval <= 2**31 - 1):
        raise ValueError(f"randint bounds [{minval}, {maxval}) exceed int32")
    span = 1 if maxval <= minval else (maxval - minval) & M32
    mult = (2**16) % span
    return span, ((mult * mult) & M32) % span


def threefry_split_ref(key: torch.Tensor, num: int) -> torch.Tensor:
    """`jax.random.split(key, num)`: keys ``[..., 2]`` -> ``[..., num, 2]``."""
    b1, b2 = _hash(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def threefry_chain_ref(keys: torch.Tensor, cycles: int) -> tuple:
    """The per-cycle subkey chain of the lanes `keys [..., 2]`:
    ``key_{c+1}, sub_c = split(key_c)`` for ``c < cycles``, as
    ``(next_keys [..., 2], subs [cycles, ..., 2])``."""
    k = keys
    subs = []
    for _ in range(cycles):
        s = threefry_split_ref(k, 2)
        k = s[..., 0, :]
        subs.append(s[..., 1, :])
    if not subs:
        return k, keys.new_empty((0,) + tuple(keys.shape))
    return k, torch.stack(subs)


def threefry_bits_ref(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """32 random bits per element (uint32 values in int64)."""
    b1, b2 = _hash(key, tuple(shape))
    return b1 ^ b2


def threefry_uniform_ref(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """`jax.random.uniform(key, shape)`: float32 in [0, 1)."""
    bits = threefry_bits_ref(key, shape)
    fbits = (bits >> 9) | 0x3F800000
    return fbits.to(torch.int32).view(torch.float32) - 1.0


def threefry_randint_ref(key: torch.Tensor, shape: tuple, minval: int,
                         maxval: int) -> torch.Tensor:
    """`jax.random.randint(key, shape, minval, maxval)` (int32): two 32-bit
    draws combined by the reference's multiply-and-remainder construction,
    so spans that are not powers of two give the reference's values."""
    span, mult = randint_span(minval, maxval)
    ks = threefry_split_ref(key, 2)
    higher = threefry_bits_ref(ks[..., 0, :], shape)
    lower = threefry_bits_ref(ks[..., 1, :], shape)
    off = (((higher % span) * mult) & M32) + (lower % span)
    off = (off & M32) % span
    val = (off + (minval & M32)) & M32
    return torch.where(val >= 2**31, val - 2**32, val).to(torch.int32)


def threefry_bernoulli_ref(key: torch.Tensor, p: float,
                           shape: tuple) -> torch.Tensor:
    """`jax.random.bernoulli(key, p, shape)` (float32 threshold)."""
    # a fill, not a host copy: the draw can be captured in a CUDA graph
    return threefry_uniform_ref(key, shape) < torch.full(
        (), p, dtype=torch.float32, device=key.device)
