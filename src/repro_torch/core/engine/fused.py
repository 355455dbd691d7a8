"""The fused and occupancy-compacted cycle steps (`SimConfig.step_impl`
"fused" and "compact").

Port of the single-device part of `repro.core.engine.fused`; see the
reference module for the design.  Both steps are bit-identical to the
oracle step (`step.make_step`, "jnp") and are built around two
observations:

ROUTE ONCE PER HOP, NOT ONCE PER CYCLE.  A packet's route out of a
channel is a pure function of its record, the channel and the lane's
fault data, so it is evaluated once, densely over the E winner rows, when
the packet is pushed, and cached in the record tail
(`state.F_OUT`/`F_CLS`/`F_META2`).  Epoch-scheduled (warm-fault) lanes
route per cycle instead and leave the tail zero.

ONE WINNER PER CHANNEL DRIVES EVERYTHING.  Grant, winner records, pops
and stats are computed channel-dense from the per-channel winner table
that `kernels.netsim.ops.cycle_core` returns: the hand-written CUDA
kernel on a CUDA device, its plain PyTorch version on the CPU, whatever
`cfg.grant_impl` names.  Its 64-bit key orders (itime, priority) for any
itime, so the port needs no int32-overflow fallback; `grant_form` still
reports the form the reference would compile.  The dense step gathers
its buffer-head records and its winners' records with
`kernels.netsim.ops.head_records_dense` and `head_records_picked` (on a
CUDA device one thread a 32-byte record, where aten's gather runs a
block a row).

The compact step first compacts the live rows (non-empty (channel, VC)
buffers, then non-empty source queues, in the oracle's row order) into an
active set of C slots, so request assembly and arbitration run over C
rows instead of ``N = E_req * NV + T``.  Each slot's grant priority is
its GLOBAL row id, so every tie resolves as in the oracle.  Whether C
bounded the live set is certified by the exact census folded into
`SimStats.occ_peak`; the sweep re-runs the grid at the next rung of the
capacity ladder when it did not (`sweep._PendingLanes.finish`).

Every tensor carries the leading lane dimension ``B``.

CHANNEL SHARDING (`make_fused_step(..., shards=K)`, the reference's
`_make_sharded`).  Each lane row's channel-id space is cut into K
contiguous blocks, one a shard, each shard on a device of its own (the
eject block trails the id space, so the cut is a plain slice).  The two
big arrays are block-partitioned: `b_pkt` on its channel axis (``Ek =
Ep / K`` channels a shard), `s_pkt` on its terminal axis (``Tk``);
everything else is replicated on every shard and advanced identically
from the exchanged tables, as in the reference's SPMD program.  Rows
carry GLOBAL priorities (buffer row (c, v) ``c * NV + v``, source row t
``Ep * NV + t``), so every tie resolves as in the unsharded step; ghost
channels (type -1, dead) and ghost terminals (no injection channel) pad
E and T to multiples of K (`fused_pad`).  One cycle runs in phases over
the K shards: every shard's partial per-channel minima, the exchange
(a minimum; twice with the age-tie re-mask between in the `two_pass`
form), every shard's winner records, the exchange (a sum: the winner
records, the reaper's pop vectors — a concatenation, the shards own
disjoint blocks — and the stranded and reaped gauges), every shard's
commit.  `exchange` is the one place the shards meet.  The sharded step
uses the plain `scatter_reduce` grant, as the reference's uses its jnp
segment-min partials: the global minimum exists only after the exchange,
so the `cycle_core` kernel has nothing to reduce.
"""
from __future__ import annotations

import numpy as np
import torch

from ... import env_int
from ... import random as jr
from ...device import physical_device
from ...kernels.netsim import ops as netsim_ops
from ...spans import span
from ...tensors import flat_index, lane_take, take, take_flat, to_device
from ..routing import num_vcs
from ..topology import EJECT, NUM_CH_TYPES, Network
from ..traffic import as_pattern
from .inject import make_inject_fn, make_misroute_fn
from .state import (F_CLS, F_DEST, F_ITIME, F_META, F_META2, F_MIS, F_OUT,
                    F_READY, INF32, SimState, build_consts, is_scheduled,
                    make_state, resolve_device, resolve_epoch,
                    resolve_reap_age, with_sink_row)
from .stats import live_rows, zero_stats

# winner-record columns (the [B, E, NUM_W_FIELDS] table, exchanged across
# channel shards): destination, generation cycle, misroute wg,
# meta-to-store, class
NUM_W_FIELDS = 5
W_DEST, W_ITIME, W_MIS, W_META, W_CLS = range(NUM_W_FIELDS)


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def grant_form(net: Network, cfg, shards: int = 1) -> str:
    """The grant form the REFERENCE's fused and compact steps compile for
    this (net, cfg): ``"combined"`` — one packed ``itime * R2 + prio``
    segment-min — or ``"two_pass"``, its fallback when the packed key
    could exceed int32 (``cycles * R2 + R2 - 1``).  ``shards`` matters
    because a K-way channel shard packs GLOBAL priorities over the
    ghost-padded ``Ep * NV + Tp`` id space, a larger modulus than the
    unsharded ``E_req * NV + T``.  The unsharded steps' kernel serves both
    forms with one 64-bit key, so there it is reporting only; the sharded
    step runs the form this names."""
    NV = (num_vcs(net.meta["kind"], cfg.vc_mode, cfg.nonminimal)
          * cfg.vcs_per_class)
    if shards <= 1:
        N = net.first_eject * NV + net.num_terminals
    else:
        ch_pad, term_pad = fused_pad(net, shards)
        N = ((net.num_channels + ch_pad) * NV
             + net.num_terminals + term_pad)
    R2 = _pow2(N)
    cycles = cfg.warmup + cfg.measure
    return ("combined" if cycles * R2 + (R2 - 1) < 2**31 - 1
            else "two_pass")


def fused_pad(net: Network, shards: int) -> tuple[int, int]:
    """(ch_pad, term_pad): the ghost channels and terminals a K-way channel
    shard needs so each shard's block is dense (`make_state(...,
    ch_pad=, term_pad=)` pads the state; the step pads its tables)."""
    E, T = net.num_channels, net.num_terminals
    return _round_up(E, shards) - E, _round_up(T, shards) - T


def make_fused_step(net: Network, cfg, pattern, inject_mask=None, *,
                    shards: int = 1, device=None, devices=None):
    """Returns (step, consts); signature-compatible with `step.make_step`.

    ``shards=K > 1`` builds the channel-sharded step (`ShardedStep`) over
    `devices`, K (logical) devices, shard s on ``devices[s]`` (default:
    all K shards on `device`); its state is a list of K shard states
    (`ShardedStep.make_states`)."""
    if shards > 1:
        if devices is None:
            devices = [resolve_device(device)] * shards
        step = ShardedStep(net, cfg, pattern, inject_mask, shards, devices)
        return step, step.consts
    device = resolve_device(device)
    pattern, inject_mask = as_pattern(pattern, inject_mask)
    consts, route_kernel = build_consts(net, cfg, device=device)
    step = _make_unsharded(net, cfg, pattern, inject_mask, consts,
                           route_kernel)
    return step, consts


def _occ_tables(b_count, NC, vpc):
    """Per-(channel, class) least-occupied-VC tables: (occ_min
    [B, E, NC], occ_arg [B, E, NC]); the FIRST minimum on ties, like the
    oracle's `expand_vcs`."""
    occ = b_count.reshape(b_count.shape[:-1] + (NC, vpc))
    best, arg = occ[..., 0], torch.zeros_like(occ[..., 0])
    for j in range(1, vpc):
        better = occ[..., j] < best
        arg = torch.where(better, j, arg)
        best = torch.where(better, occ[..., j], best)
    return best, arg


def _winner_vc(wcls, occ_min, occ_arg, NC, vpc):
    """(wvc [B, E], wovc [B, E]) for the winner table: the winning row
    asked for the least-occupied VC of its class, so a one-hot select
    over the NC class columns reproduces `expand_vcs`' per-row values."""
    csel = wcls[..., None] == torch.arange(NC, dtype=torch.int32,
                                           device=wcls.device)
    i32 = torch.int32
    wovc = torch.where(csel, occ_min, 0).sum(-1, dtype=i32)
    wvc = wcls * vpc + torch.where(csel, occ_arg, 0).sum(-1, dtype=i32)
    return wvc, wovc


def _row_elig(elig_ck, out, cls, E):
    """Per-row credit/eject eligibility: one gather of the per-lane
    [B, E, NC] table at each row's (output channel, class)."""
    return lane_take(elig_ck, out.clamp(0, E - 1), cls)


def _grant(ok, out, itime, prio, ch_ok, E, R2, use_combined):
    """The reference's plain grant over ``[B, N]`` rows in its two int32
    forms: the packed ``itime * R2 + prio`` key (``use_combined``, valid
    only while that fits int32) or the two-pass age-then-priority
    reduction.  Returns (won_ch [B, E], wprio [B, E]).  The steps call
    `ops.cycle_core` instead; this is the independent yardstick its
    64-bit key is held to."""
    B = ok.shape[0]
    seg = torch.where(ok, out, E).long()
    fill = torch.full((B, E + 1), INF32, dtype=torch.int32,
                      device=ok.device)
    if use_combined:
        key = torch.where(ok, itime * R2 + prio, INF32)
        m = fill.scatter_reduce_(1, seg, key, "amin")[:, :E]
        m = torch.where(ch_ok, m, INF32)
        won_ch = m != INF32
        return won_ch, torch.where(won_ch, m & (R2 - 1), 0)
    m1 = fill.clone().scatter_reduce_(1, seg, torch.where(ok, itime, INF32),
                                      "amin")
    tie = ok & (itime == lane_take(m1, torch.where(ok, out, 0)))
    m2 = fill.scatter_reduce_(1, seg, torch.where(tie, prio, INF32),
                              "amin")[:, :E]
    won_ch = ch_ok & (m1[:, :E] != INF32)
    return won_ch, torch.where(won_ch, m2, 0)


def compact_rows(net: Network, cfg) -> int:
    """N, the unsharded request-row count (`E_req * NV + T`) — the
    compact step's capacity ladder is sized against this."""
    NV = (num_vcs(net.meta["kind"], cfg.vc_mode, cfg.nonminimal)
          * cfg.vcs_per_class)
    return net.first_eject * NV + net.num_terminals


def capacity_ladder(N: int) -> tuple[int, ...]:
    """The compact step's capacity rungs for an N-row request grid:
    ``ceil(N/8) < ceil(N/4) < ceil(N/2) < N`` (deduplicated for tiny N).
    The top rung C = N can never overflow, so escalation terminates."""
    return tuple(sorted({-(-N // 8), -(-N // 4), -(-N // 2), N}))


def next_rung(N: int, floor: int) -> int:
    """The smallest ladder rung >= `floor` (the escalation target when a
    run's `occ_peak` reached `floor`); N when `floor` exceeds the top."""
    for r in capacity_ladder(N):
        if r >= floor:
            return r
    return N


def initial_capacity(N: int) -> int:
    """The rung a compact step starts at: the smallest ladder rung that
    covers REPRO_COMPACT_CAP when set, else ``ceil(N/4)``."""
    cap = env_int("REPRO_COMPACT_CAP", 0)
    if cap > 0:
        return next_rung(N, min(cap, N))
    ladder = capacity_ladder(N)
    return ladder[1] if len(ladder) > 1 else ladder[0]


def make_compact_step(net: Network, cfg, pattern, inject_mask=None, *,
                      capacity: int | None = None, device=None):
    """The occupancy-compacted fused step (`cfg.step_impl="compact"`):
    returns (step, consts), signature-compatible with `step.make_step`.
    `capacity=None` starts at `initial_capacity(N)`; the step carries
    `compact_capacity` and `compact_rows` for the sweep's bookkeeping."""
    device = resolve_device(device)
    pattern, inject_mask = as_pattern(pattern, inject_mask)
    consts, route_kernel = build_consts(net, cfg, device=device)
    N = consts["E_req"] * consts["NV"] + consts["T"]
    C = initial_capacity(N) if capacity is None else int(capacity)
    if not 1 <= C <= N:
        raise ValueError(f"compact capacity {C} outside [1, {N}]")
    step = _make_compact(net, cfg, pattern, inject_mask, consts,
                         route_kernel, C)
    step.compact_capacity = C
    step.compact_rows = N
    return step, consts


class _Tables:
    """The static per-channel tables both steps close over."""

    def __init__(self, consts):
        ch_tbl = consts["ch_tbl"]
        self.ch_dst = consts["ch_dst"]
        self.ch_type = ch_tbl[:, 0]
        self.ch_dst_wg = ch_tbl[:, 1]
        self.ch_lat = ch_tbl[:, 2]
        self.ch_ser = consts["ch_ser"]
        self.is_ej_ch = self.ch_type == EJECT
        self.inject_ch = consts["inject_ch"]
        dev = self.ch_dst.device
        E = consts["E"]
        self.ch_iota = torch.arange(E, dtype=torch.int32, device=dev)
        self.vc_iota = torch.arange(consts["NV"], dtype=torch.int32,
                                    device=dev)
        self.type_oh = self.ch_type[:, None] == torch.arange(
            NUM_CH_TYPES, dtype=torch.int32, device=dev)


def _commit(state, tb, t, cached, fl, route_kernel, won_ch, w, occ_min,
            occ_arg, whead_of, NC, vpc, S):
    """The winner-table half of a cycle, shared by both steps: the pushed
    records (with the route-once-per-hop evaluation when `cached`), the
    push into `b_pkt` (in place), and the push's per-(channel, VC) count.
    `w` is the ``[B, E, 5]`` winner-record table; `whead_of(wvc)` returns
    the winning VC's ring head.  Returns (push [B, E], vc_oh
    [B, E, NV], witime [B, E])."""
    B, E = won_ch.shape
    wdest, witime = w[..., W_DEST], w[..., W_ITIME]
    wmis, wmeta, wcls = w[..., W_MIS], w[..., W_META], w[..., W_CLS]
    wvc, wovc = _winner_vc(wcls, occ_min, occ_arg, NC, vpc)
    entered = (wmis >= 0) & (tb.ch_dst_wg == wmis)
    wmis = torch.where(entered, -1, wmis)
    push = won_ch & ~tb.is_ej_ch
    vc_oh = wvc[..., None] == tb.vc_iota
    wslot = (whead_of(wvc) + wovc) % S
    if cached:
        out2, cls2, meta2 = route_kernel(fl, tb.ch_dst.expand(B, E), wdest,
                                         wmis, wmeta)
        tail = [out2.to(torch.int32), cls2.to(torch.int32),
                meta2.to(torch.int32)]
    else:
        z = torch.zeros_like(wdest)
        tail = [z, z, z]
    new_rec = torch.stack(
        [wdest, witime, wmis, wmeta, (t + tb.ch_lat).expand(B, E)] + tail,
        dim=-1)
    # non-pushing channels write into the spare row E (never read),
    # spread over its (VC, slot) entries
    store = with_sink_row(state.b_pkt)          # [B, E+1, NV, S, F]
    NV = store.shape[2]
    spread = tb.ch_iota % (NV * S)
    lane = torch.arange(B, device=won_ch.device).view(B, 1)
    flat = (((lane * (E + 1) + torch.where(push, tb.ch_iota, E)) * NV
             + torch.where(push, wvc, spread // S)) * S
            + torch.where(push, wslot, spread % S))
    store.view(-1, new_rec.shape[-1]).index_copy_(
        0, flat.reshape(-1), new_rec.reshape(-1, new_rec.shape[-1]))
    return push, vc_oh, witime


def _stats(st, tb, t, won_ch, witime, occ, valid, out, undel, reap):
    """Channel-dense stats, bit-equal to the oracle's row sums: the
    winners biject the granting channels and the sums are exact int32."""
    i32 = torch.int32
    w_ej = won_ch & tb.is_ej_ch
    hops = (won_ch[..., None] & tb.type_oh).sum(1, dtype=i32)
    if reap is None:
        stranded = (valid & (out < 0)).sum(-1, dtype=i32)
        reaped = st.reaped
    else:
        stranded = (undel & ~reap).sum(-1, dtype=i32)
        reaped = st.reaped + reap.sum(-1, dtype=i32)
    lat = torch.where(w_ej, t - witime, 0).sum(-1, dtype=i32)
    return st.replace(
        delivered=st.delivered + w_ej.sum(-1, dtype=i32),
        lat_sum=st.lat_sum + lat.to(torch.float32),
        hops=st.hops + hops, stranded=stranded, reaped=reaped,
        occ_peak=torch.maximum(st.occ_peak, occ))


def _reap(reap_age, valid, out, itime, fl, t, E):
    """(undeliverable rows, reaped rows): rows parked on -1 or requesting
    a dead channel, and those of them past the park age; (None, None)
    with the reaper off."""
    if not reap_age:
        return None, None
    undel = valid & ((out < 0)
                     | ~lane_take(fl["ch_alive"], out.clamp(0, E - 1)))
    return undel, undel & (t - itime >= reap_age)


def _make_compact(net, cfg, pattern, inject_mask, consts, route_kernel, C):
    inject = make_inject_fn(net, cfg, consts, pattern, inject_mask)
    NV, E, T, ER = consts["NV"], consts["E"], consts["T"], consts["E_req"]
    S, Q = cfg.buf_pkts, cfg.srcq_pkts
    vpc = cfg.vcs_per_class
    NC = NV // vpc
    N = ER * NV + T
    R2 = _pow2(N)
    reap_age = resolve_reap_age(cfg)   # 0 runs no reap logic at all
    tb = _Tables(consts)
    dev = tb.ch_dst.device
    slot_iota = torch.arange(C, dtype=torch.int32, device=dev)
    targets = slot_iota + 1

    def step(state, t_key_rate_fl):
        t, key, rate_pkt, fl = t_key_rate_fl
        cached = not is_scheduled(fl)
        with span("step.inject"):
            fl = resolve_epoch(fl, t)
            state = inject(state, t, key, rate_pkt, fl)
        with span("step.requests"):
            B = state.b_head.shape[0]
            lane = torch.arange(B, device=dev).view(B, 1)

            # live-row census + stable compaction.  `occ` is exact (dense,
            # independent of C): it feeds the occ_peak certificate.  Slot k
            # holds the first row whose live prefix count reaches k + 1 —
            # the k-th live row in the oracle's row order — or the sentinel N
            # past the live count, so `aid` stays sorted per lane; live rows
            # past slot C - 1 are dropped, as in the reference
            live = torch.cat([(state.b_count[:, :ER] > 0).reshape(B, -1),
                              state.s_count > 0], 1)                  # [B, N]
            cs = torch.cumsum(live, 1, dtype=torch.int32)
            occ = cs[:, -1]
            aid = torch.searchsorted(cs, targets.expand(B, C).contiguous(),
                                     out_int32=True)                 # [B, C]
            slot_ok = slot_iota < occ[:, None]

            # per-slot request assembly: one C-row head gather + one C-row
            # source-queue gather, merged by slot kind
            is_buf = aid < ER * NV
            e = (aid // NV).clamp(0, ER - 1)
            v = aid.clamp(0, ER * NV - 1) % NV
            tt = (aid - ER * NV).clamp(0, T - 1)
            bh = lane_take(state.b_head, e, v)
            brec = take(with_sink_row(state.b_pkt), lane, e, v, bh,
                        clamp=False)                             # [B, C, 8]
            srec = take(state.s_pkt, lane, tt, lane_take(state.s_head, tt),
                        clamp=False)                             # [B, C, 3]
            ready = ~is_buf | (brec[..., F_READY] <= t)
            valid = slot_ok & ready
            if cached:
                out_b, cls_b, meta2_b = (brec[..., F_OUT], brec[..., F_CLS],
                                         brec[..., F_META2])
            else:
                out_b, cls_b, meta2_b = route_kernel(
                    fl, take(tb.ch_dst, e), brec[..., F_DEST],
                    brec[..., F_MIS], brec[..., F_META])
            out = torch.where(is_buf, out_b, take(tb.inject_ch, tt)).to(
                torch.int32)
            cls = torch.where(is_buf, cls_b, 0).to(torch.int32)
            itime = torch.where(is_buf, brec[..., F_ITIME], srec[..., F_ITIME])
            dest = torch.where(is_buf, brec[..., F_DEST], srec[..., F_DEST])
            mis = torch.where(is_buf, brec[..., F_MIS], srec[..., F_MIS])
            meta2 = torch.where(is_buf, meta2_b, 0).to(torch.int32)
            rowok = valid & (out >= 0)
            # undeliverable rows are live, so whenever occ <= C they are all
            # in the active set: the reap mask is exact under the same
            # certificate that covers the grant
            undel, reap = _reap(reap_age, valid, out, itime, fl, t, E)

        # grant over the C active rows; the global row id is the
        # oracle's tie-break
        with span("step.grant"):
            occ_min, occ_arg = _occ_tables(state.b_count, NC, vpc)
            elig_ck = (occ_min < S) | tb.is_ej_ch[:, None]
            ok = rowok & _row_elig(elig_ck, out, cls, E)
            ch_ok = (state.ch_busy == 0) & fl["ch_alive"]
            won_ch, wprio, win_slot = netsim_ops.cycle_core(
                out, itime, ok, ch_ok, r2=R2, prio=aid)

        # dense winner table: each granting channel's winning row id
        # back to its active slot (aid is sorted: one binary search)
        with span("step.commit"):
            wslot_i = torch.searchsorted(aid, wprio, out_int32=True).clamp(
                0, C - 1)
            crec = torch.stack([dest, itime, mis, meta2, cls], dim=-1)
            w = lane_take(crec, wslot_i)                          # [B, E, 5]
            push, vc_oh, witime = _commit(
                state, tb, t, cached, fl, route_kernel, won_ch, w, occ_min,
                occ_arg, lambda wvc: lane_take(state.b_head, tb.ch_iota,
                                               wvc.clamp(0, NV - 1)),
                NC, vpc, S)

            # pops: reaped rows pop like winners but push nowhere (the masks
            # are disjoint); rows that pop nothing add 0 at distinct places
            i32 = torch.int32
            pop = win_slot if reap is None else win_slot | reap
            spread = torch.arange(B * C, device=dev).view(B, C)
            pop_b = pop & is_buf
            pop1 = torch.zeros((B, E, NV), dtype=i32, device=dev)
            pop1.view(-1).index_add_(
                0, torch.where(pop_b, (lane * E + e) * NV + v,
                               spread % pop1.numel()).reshape(-1),
                pop_b.reshape(-1).to(i32))
            pop_t = pop & ~is_buf
            pop_s = torch.zeros((B, T), dtype=i32, device=dev)
            pop_s.view(-1).index_add_(
                0, torch.where(pop_t, lane * T + tt,
                               spread % pop_s.numel()).reshape(-1),
                pop_t.reshape(-1).to(i32))
            b_head = (state.b_head + pop1) % S
            b_count = state.b_count - pop1 + (push[..., None] & vc_oh).to(i32)
            s_head = (state.s_head + pop_s) % Q
            s_count = state.s_count - pop_s
            ch_busy = torch.where(won_ch, tb.ch_ser - 1,
                                  torch.clamp(state.ch_busy - 1, min=0))
            st = _stats(state.stats, tb, t, won_ch, witime, occ, valid, out,
                        undel, reap)
        return state.replace(
            b_head=b_head, b_count=b_count, s_head=s_head, s_count=s_count,
            ch_busy=ch_busy, stats=st), None

    return step


def _make_unsharded(net, cfg, pattern, inject_mask, consts, route_kernel):
    inject = make_inject_fn(net, cfg, consts, pattern, inject_mask)
    NV, E, T, ER = consts["NV"], consts["E"], consts["T"], consts["E_req"]
    S, Q = cfg.buf_pkts, cfg.srcq_pkts
    vpc = cfg.vcs_per_class
    NC = NV // vpc
    N = ER * NV + T
    R2 = _pow2(N)
    reap_age = resolve_reap_age(cfg)   # 0 runs no reap logic at all
    tb = _Tables(consts)
    dev = tb.ch_dst.device
    cur_rows = tb.ch_dst[:ER].repeat_interleave(NV)
    t_idx = torch.arange(T, device=dev)

    def step(state, t_key_rate_fl):
        t, key, rate_pkt, fl = t_key_rate_fl
        cached = not is_scheduled(fl)
        with span("step.inject"):
            fl = resolve_epoch(fl, t)
            state = inject(state, t, key, rate_pkt, fl)
        with span("step.requests"):
            occ = live_rows(state)
            B = state.b_head.shape[0]

            # request rows in the oracle's order ([:ER]*NV buffer heads, then
            # T source queues); the row index IS the oracle's tie-break.
            # The head records, whole, by the hand-written gather
            head = netsim_ops.head_records_dense(
                with_sink_row(state.b_pkt), state.b_head, ER)
            r_valid = ((state.b_count[:, :ER] > 0).reshape(B, -1)
                       & (head[..., F_READY] <= t))
            if cached:
                out_b, cls_b, meta2_b = (head[..., F_OUT], head[..., F_CLS],
                                         head[..., F_META2])
            else:
                out_b, cls_b, meta2_b = route_kernel(
                    fl, cur_rows.expand(B, -1), head[..., F_DEST],
                    head[..., F_MIS], head[..., F_META])
            lane = torch.arange(B, device=dev).view(B, 1)
            sq = take(state.s_pkt, lane, t_idx, state.s_head,
                      clamp=False)                               # [B, T, 3]
            out = torch.cat([out_b, tb.inject_ch.expand(B, T)], 1).to(
                torch.int32)
            cls = torch.cat([cls_b, torch.zeros_like(sq[..., 0])], 1).to(
                torch.int32)
            itime = torch.cat([head[..., F_ITIME], sq[..., F_ITIME]], 1)
            valid = torch.cat([r_valid, state.s_count > 0], 1)
            rowok = valid & (out >= 0)
            undel, reap = _reap(reap_age, valid, out, itime, fl, t, E)

        # grant: per-row credit gather, then the arbitration core
        with span("step.grant"):
            occ_min, occ_arg = _occ_tables(state.b_count, NC, vpc)
            elig_ck = (occ_min < S) | tb.is_ej_ch[:, None]
            ok = rowok & _row_elig(elig_ck, out, cls, E)
            ch_ok = (state.ch_busy == 0) & fl["ch_alive"]
            won_ch, wprio, win_row = netsim_ops.cycle_core(out, itime, ok,
                                                           ch_ok, r2=R2)

        # dense winner table: two E-row gathers (buffer / source rows)
        with span("step.commit"):
            is_buf = wprio < ER * NV
            bclip = wprio.clamp(0, ER * NV - 1)
            wb = netsim_ops.head_records_picked(head, bclip)
            ws = lane_take(sq, (wprio - ER * NV).clamp(0, T - 1))
            if cached:
                wmeta, wcls = wb[..., F_META2], wb[..., F_CLS]
            else:
                wmeta = lane_take(meta2_b, bclip)
                wcls = lane_take(cls_b, bclip)
            w = torch.stack(
                [torch.where(is_buf, wb[..., F_DEST], ws[..., F_DEST]),
                 torch.where(is_buf, wb[..., F_ITIME], ws[..., F_ITIME]),
                 torch.where(is_buf, wb[..., F_MIS], ws[..., F_MIS]),
                 torch.where(is_buf, wmeta, 0).to(torch.int32),
                 torch.where(is_buf, wcls, 0).to(torch.int32)], dim=-1)
            push, vc_oh, witime = _commit(
                state, tb, t, cached, fl, route_kernel, won_ch, w, occ_min,
                occ_arg, lambda wvc: torch.where(
                    wvc[..., None] == tb.vc_iota, state.b_head, 0).sum(
                        -1, dtype=torch.int32),
                NC, vpc, S)

            # pops straight from the kernel's per-row mask; reaped rows pop
            # like winners but push nowhere (the masks are disjoint)
            i32 = torch.int32
            pop = win_row if reap is None else win_row | reap
            pop1 = torch.cat(
                [pop[:, :ER * NV].reshape(B, ER, NV).to(i32),
                 torch.zeros((B, E - ER, NV), dtype=i32, device=dev)], 1)
            pop_s = pop[:, ER * NV:].to(i32)
            b_head = (state.b_head + pop1) % S
            b_count = state.b_count - pop1 + (push[..., None] & vc_oh).to(i32)
            s_head = (state.s_head + pop_s) % Q
            s_count = state.s_count - pop_s
            ch_busy = torch.where(won_ch, tb.ch_ser - 1,
                                  torch.clamp(state.ch_busy - 1, min=0))
            st = _stats(state.stats, tb, t, won_ch, witime, occ, valid, out,
                        undel, reap)
        return state.replace(
            b_head=b_head, b_count=b_count, s_head=s_head, s_count=s_count,
            ch_busy=ch_busy, stats=st), None

    return step


def exchange(parts: list, op: str) -> list:
    """One exchange of the channel-sharded step: the all-reduce of `parts`
    (shard s's tensor on shard s's device) by `op`, ``"min"`` or
    ``"sum"``, reduced on the lead shard's device and copied back, one
    copy a device.  Returns the reduced tensor on each shard's device.
    Shards in one process meet only here, so a run of one process a
    shard would put `torch.distributed.all_reduce` under it."""
    acc = parts[0]
    for p in parts[1:]:
        p = p.to(acc.device, non_blocking=True)
        acc = torch.minimum(acc, p) if op == "min" else acc + p
    on = {acc.device: acc}
    for p in parts:
        if p.device not in on:
            on[p.device] = acc.to(p.device, non_blocking=True)
    return [on[p.device] for p in parts]


def _pad(x, n: int, fill):
    """`x` ([E] or [B, E]) padded with `n` entries of `fill` on its last
    dim."""
    if n == 0:
        return x
    return torch.cat([x, x.new_full(x.shape[:-1] + (n,), fill)], -1)


class _ShardTables:
    """The padded static tables of the channel-sharded step on one
    (physical) device, shared by the shards that live there."""

    def __init__(self, net, cfg, pattern, inject_mask, K, device):
        consts, self.route_kernel = build_consts(net, cfg, device=device)
        self.consts = consts
        E, T, NV = consts["E"], consts["T"], consts["NV"]
        ch_pad, term_pad = fused_pad(net, K)
        self.Ep, self.Tp = E + ch_pad, T + term_pad
        self.Ek, self.Tk = self.Ep // K, self.Tp // K
        i32 = torch.int32
        ch_tbl = consts["ch_tbl"]
        # ghost channels: dead, type -1; ghost terminals: no injection
        # channel, never generate
        self.ch_dst = _pad(consts["ch_dst"].clamp(0, net.num_nodes - 1),
                           ch_pad, 0)
        self.ch_type = _pad(ch_tbl[:, 0], ch_pad, -1)
        self.ch_dst_wg = _pad(ch_tbl[:, 1], ch_pad, 0)
        self.ch_lat = _pad(ch_tbl[:, 2], ch_pad, 0)
        self.ch_ser = _pad(torch.broadcast_to(consts["ch_ser"], (E,)),
                           ch_pad, 1)
        self.inject_ch = _pad(consts["inject_ch"], term_pad, -1)
        self.is_ej_ch = self.ch_type == EJECT
        self.type_oh = self.ch_type[:, None] == torch.arange(
            NUM_CH_TYPES, dtype=i32, device=device)
        self.vc_iota = torch.arange(NV, dtype=i32, device=device)
        self.ek_iota = torch.arange(self.Ek, dtype=i32, device=device)
        self.tk_iota = torch.arange(self.Tk, device=device)
        self.terms = torch.arange(T, device=device)
        self.inj_mask = (torch.ones(T, dtype=torch.bool, device=device)
                         if inject_mask is None else torch.as_tensor(
                             np.asarray(inject_mask).astype(bool),
                             device=device))
        self.gen_mis = make_misroute_fn(net, cfg, consts)
        self.pattern = pattern
        self.ch_pad, self.term_pad = ch_pad, term_pad


class ShardedStep:
    """The channel-sharded fused step (see the module docstring): K shards,
    shard s on ``devices[s]`` (logical devices; shards on one physical
    device share its tables).  `step(states, (t, keys, rates, fls))`
    advances one cycle: `states` holds K shard states (`make_states`),
    `keys`, `rates` and `fls` one copy a shard (`place`); returns
    (states, None).  Every shard's replicated counters are equal; the
    lead shard's are the run's."""

    def __init__(self, net, cfg, pattern, inject_mask, K, devices):
        if len(devices) != K:
            raise ValueError(f"{K} shards need {K} devices, got "
                             f"{len(devices)}")
        self.net, self.cfg, self.shards = net, cfg, K
        self.devices = [torch.device(d) for d in devices]
        self.physical = [physical_device(d) for d in self.devices]
        pattern, inject_mask = as_pattern(pattern, inject_mask)
        tabs = {}
        for dev in self.physical:
            if dev not in tabs:
                tabs[dev] = _ShardTables(net, cfg, pattern, inject_mask, K,
                                         dev)
        self._tabs = [tabs[dev] for dev in self.physical]
        tb = self._tabs[0]
        self.consts = tb.consts
        self.form = grant_form(net, cfg, K)
        # the global-priority modulus of the packed key
        self.R2 = _pow2(tb.Ep * tb.consts["NV"] + tb.Tp)
        self.reap_age = resolve_reap_age(cfg)    # 0 runs no reap logic
        self.ch_pad, self.term_pad = fused_pad(net, K)

    # -- placement ---------------------------------------------------------

    def make_states(self, batch: tuple) -> list:
        """K fresh shard states of `batch` lanes: each its own `b_pkt` and
        `s_pkt` blocks, the rest at the padded sizes."""
        tb = self._tabs[0]
        return [make_state(self.net, self.cfg, self.consts["NV"], batch,
                           ch_pad=self.ch_pad, term_pad=self.term_pad,
                           blocks=(tb.Ek, tb.Tk), device=dev)
                for dev in self.physical]

    def place(self, x) -> list:
        """One copy of `x` (a tensor or a dict of them) a shard, on the
        shard's device; shards on one device share it."""
        on = {}
        for dev in self.physical:
            if dev not in on:
                on[dev] = ({k: to_device(v, dev) for k, v in x.items()}
                           if isinstance(x, dict) else to_device(x, dev))
        return [on[dev] for dev in self.physical]

    def gather(self, states: list) -> SimState:
        """The shard states as one unsharded `SimState` on the lead shard's
        device (ghosts dropped; `b_pkt` without its spare row)."""
        E, T = self.net.num_channels, self.net.num_terminals
        lead = states[0]
        dev = lead.b_head.device
        cat = lambda k: torch.cat([getattr(s, k).to(dev) for s in states],
                                  1)
        return SimState(
            b_pkt=cat("b_pkt")[:, :E], s_pkt=cat("s_pkt")[:, :T],
            b_head=lead.b_head[:, :E], b_count=lead.b_count[:, :E],
            s_head=lead.s_head[:, :T], s_count=lead.s_count[:, :T],
            ch_busy=lead.ch_busy[:, :E], stats=lead.stats)

    def reset_stats(self, states: list) -> list:
        """The warmup reset on every shard."""
        return [s.replace(stats=zero_stats(s.stats)) for s in states]

    # -- one cycle ---------------------------------------------------------

    def __call__(self, states, t_keys_rates_fls):
        t, keys, rates, fls = t_keys_rates_fls
        K = self.shards
        loc = [self._partials(s, states[s], t, keys[s], rates[s], fls[s])
               for s in range(K)]
        if self.form == "combined":
            m = exchange([c["part"] for c in loc], "min")
            for c, m_s in zip(loc, m):
                self._won_combined(c, m_s)
        else:
            m1 = exchange([c["part"] for c in loc], "min")
            for c, m1_s in zip(loc, m1):
                self._tie(c, m1_s)
            m2 = exchange([c["part"] for c in loc], "min")
            for c, m1_s, m2_s in zip(loc, m1, m2):
                self._won_two_pass(c, m1_s, m2_s)
        sums = [self._records(s, loc[s]) for s in range(K)]
        total = [exchange([p[i] for p in sums], "sum")
                 for i in range(len(sums[0]))]
        return [self._commit(s, loc[s], [x[s] for x in total])
                for s in range(K)], None

    def _inject(self, tb, s, state, t, key, rate_pkt, fl):
        """The reference's sharded inject: generation over all T terminals
        on every shard (the same draws), the push into the local s_pkt
        block only."""
        T, Q = tb.consts["T"], self.cfg.srcq_pkts
        t0, Tk = s * tb.Tk, tb.Tk
        B = key.shape[0]
        ks = jr.split(key, 3)
        k_gen, k_dest, k_mis = ks[:, 0], ks[:, 1], ks[:, 2]
        alive = fl["term_alive"]
        gen = (jr.uniform(k_gen, (T,)) < rate_pkt[:, None]) & tb.inj_mask
        dest = tb.pattern(k_dest, t).to(torch.int32)
        gen = gen & (dest != tb.terms)
        gen = gen & alive & lane_take(alive, dest)
        with span("route.misroute"):
            mis = tb.gen_mis(k_mis, dest, state.b_count, fl)
        space = state.s_count[:, :T] < Q
        push = gen & space
        slot = (state.s_head[:, :T] + state.s_count[:, :T]) % Q
        itime = (t.to(dest.dtype).expand_as(dest)
                 if isinstance(t, torch.Tensor) else torch.full_like(dest, t))
        rec = torch.stack([dest, itime, mis], dim=-1)
        pushP = _pad(push, tb.term_pad, False)
        push_l = pushP[:, t0:t0 + Tk]
        slot_l = _pad(slot, tb.term_pad, 0)[:, t0:t0 + Tk]
        rec_l = torch.cat([rec, rec.new_zeros((B, tb.term_pad, 3))],
                          1)[:, t0:t0 + Tk]
        lane = torch.arange(B, device=dest.device)[:, None]
        flat = flat_index(state.s_pkt.shape, (lane, tb.tk_iota, slot_l),
                          clamp=False)
        rec_l = torch.where(push_l[..., None], rec_l,
                            take_flat(state.s_pkt, 3, flat))
        state.s_pkt.view(-1, 3).index_copy_(0, flat.reshape(-1),
                                            rec_l.reshape(-1, 3))
        st = state.stats
        i32 = torch.int32
        st = st.replace(
            generated=st.generated + gen.sum(-1, dtype=i32),
            dropped=st.dropped + (gen & ~space).sum(-1, dtype=i32))
        return state.replace(s_count=state.s_count + pushP, stats=st)

    def _partials(self, s, state, t, key, rate_pkt, fl):
        """Phase 1 on shard s: inject, the local request rows (the shard's
        channel and terminal blocks, GLOBAL priorities) and their partial
        per-channel minima."""
        tb, cfg = self._tabs[s], self.cfg
        NV, S = tb.consts["NV"], cfg.buf_pkts
        vpc = cfg.vcs_per_class
        Ep, Ek, Tk = tb.Ep, tb.Ek, tb.Tk
        c0, t0 = s * Ek, s * Tk
        cached = not is_scheduled(fl)
        fl = resolve_epoch(fl, t)
        state = self._inject(tb, s, state, t, key, rate_pkt, fl)
        # replicated counts (ghost rows stay zero): every shard sees the
        # same global live-row census
        occ = live_rows(state)
        B = state.b_head.shape[0]
        dev = state.b_head.device
        alive = _pad(fl["ch_alive"], tb.ch_pad, False)
        lane3 = torch.arange(B, device=dev).view(B, 1, 1)
        e_loc = tb.ek_iota.view(1, Ek, 1)
        v_idx = tb.vc_iota.view(1, 1, NV)
        head = take(with_sink_row(state.b_pkt), lane3, e_loc, v_idx,
                    state.b_head[:, c0:c0 + Ek], clamp=False).reshape(
                        B, Ek * NV, -1)
        r_valid = ((state.b_count[:, c0:c0 + Ek] > 0).reshape(B, -1)
                   & (head[..., F_READY] <= t))
        if cached:
            out_b, cls_b, meta2_b = (head[..., F_OUT], head[..., F_CLS],
                                     head[..., F_META2])
        else:
            cur = tb.ch_dst[c0:c0 + Ek].repeat_interleave(NV)
            out_b, cls_b, meta2_b = tb.route_kernel(
                fl, cur.expand(B, -1), head[..., F_DEST], head[..., F_MIS],
                head[..., F_META])
        sq = take(state.s_pkt, lane3[..., 0], tb.tk_iota,
                  state.s_head[:, t0:t0 + Tk], clamp=False)     # [B, Tk, 3]
        i32 = torch.int32
        out = torch.cat([out_b, tb.inject_ch[t0:t0 + Tk].expand(B, Tk)],
                        1).to(i32)
        cls = torch.cat([cls_b, torch.zeros_like(sq[..., 0])], 1).to(i32)
        itime = torch.cat([head[..., F_ITIME], sq[..., F_ITIME]], 1)
        valid = torch.cat([r_valid, state.s_count[:, t0:t0 + Tk] > 0], 1)
        cid = c0 + tb.ek_iota
        prio = torch.cat([(cid[:, None] * NV + tb.vc_iota).reshape(-1),
                          Ep * NV + t0 + tb.tk_iota.to(i32)])
        rowok = valid & (out >= 0)
        if self.reap_age:
            undel = valid & ((out < 0)
                             | ~lane_take(alive, out.clamp(0, Ep - 1)))
            reap = undel & (t - itime >= self.reap_age)
        else:
            undel = reap = None
        occ_min, occ_arg = _occ_tables(state.b_count, NV // vpc, vpc)
        elig_ck = (occ_min < S) | tb.is_ej_ch[:, None]
        ok = rowok & _row_elig(elig_ck, out, cls, Ep)
        ch_ok = (state.ch_busy == 0) & alive
        seg = torch.where(ok, out, Ep).long()
        key_g = torch.where(ok, itime * self.R2 + prio if
                            self.form == "combined" else itime, INF32)
        return dict(
            state=state, t=t, fl=fl, cached=cached, occ=occ, head=head,
            sq=sq, out=out, itime=itime, valid=valid, prio=prio, ok=ok,
            seg=seg, ch_ok=ch_ok, undel=undel, reap=reap, occ_min=occ_min,
            occ_arg=occ_arg, cls_b=cls_b, meta2_b=meta2_b,
            part=self._segmin(key_g, seg, B, Ep))

    @staticmethod
    def _segmin(key, seg, B, Ep):
        fill = torch.full((B, Ep + 1), INF32, dtype=torch.int32,
                          device=key.device)
        return fill.scatter_reduce_(1, seg, key, "amin")[:, :Ep]

    def _won_combined(self, c, m):
        m = torch.where(c["ch_ok"], m, INF32)
        won_ch = m != INF32
        c["won_ch"] = won_ch
        c["wprio"] = torch.where(won_ch, m & (self.R2 - 1), 0)

    def _tie(self, c, m1):
        """The two-pass form's re-mask: the age tie can span shards, so the
        local rows are held against the GLOBAL per-channel age."""
        ok, out = c["ok"], c["out"]
        tie = ok & (c["itime"] == lane_take(m1, torch.where(ok, out, 0)))
        c["part"] = self._segmin(torch.where(tie, c["prio"], INF32),
                                 c["seg"], ok.shape[0], m1.shape[1])

    def _won_two_pass(self, c, m1, m2):
        won_ch = c["ch_ok"] & (m1 != INF32)
        c["won_ch"] = won_ch
        c["wprio"] = torch.where(won_ch, m2, 0)

    def _records(self, s, c):
        """Phase 2 on shard s: the winner records of the rows it owns
        (zeros elsewhere), its reap pops placed in its blocks, and its
        stranded and reaped counts — the summed half of the exchange."""
        tb = self._tabs[s]
        NV, Ep, Ek, Tk, Tp = (tb.consts["NV"], tb.Ep, tb.Ek, tb.Tk, tb.Tp)
        c0, t0 = s * Ek, s * Tk
        won_ch, wprio = c["won_ch"], c["wprio"]
        B = won_ch.shape[0]
        i32 = torch.int32
        is_buf = wprio < Ep * NV
        se, sv, ts = wprio // NV, wprio % NV, wprio - Ep * NV
        lrow = torch.where(is_buf, (se - c0) * NV + sv, ts - t0)
        mine = won_ch & torch.where(is_buf, (se >= c0) & (se < c0 + Ek),
                                    (ts >= t0) & (ts < t0 + Tk))
        bclip = lrow.clamp(0, Ek * NV - 1)
        wb = lane_take(c["head"], bclip)
        ws = lane_take(c["sq"], lrow.clamp(0, Tk - 1))
        if c["cached"]:
            meta2b, clsb = wb[..., F_META2], wb[..., F_CLS]
        else:
            meta2b = lane_take(c["meta2_b"], bclip).to(i32)
            clsb = lane_take(c["cls_b"], bclip).to(i32)
        z = torch.zeros_like(ts)
        rec = torch.where(
            is_buf[..., None],
            torch.stack([wb[..., F_DEST], wb[..., F_ITIME], wb[..., F_MIS],
                         meta2b, clsb], -1),
            torch.stack([ws[..., F_DEST], ws[..., F_ITIME], ws[..., F_MIS],
                         z, z], -1))
        c.update(is_buf=is_buf, se=se, sv=sv, ts=ts)
        parts = [torch.where(mine[..., None], rec, 0)]
        valid, out, reap = c["valid"], c["out"], c["reap"]
        if reap is None:
            stranded = (valid & (out < 0)).sum(-1, dtype=i32)
            return parts + [stranded]
        pop1 = reap.new_zeros((B, Ep, NV), dtype=i32)
        pop1[:, c0:c0 + Ek] = reap[:, :Ek * NV].reshape(B, Ek, NV).to(i32)
        pop_s = reap.new_zeros((B, Tp), dtype=i32)
        pop_s[:, t0:t0 + Tk] = reap[:, Ek * NV:].to(i32)
        stranded = (c["undel"] & ~reap).sum(-1, dtype=i32)
        return parts + [stranded, reap.sum(-1, dtype=i32), pop1, pop_s]

    def _commit(self, s, c, summed):
        """Phase 3 on shard s: the replicated bookkeeping from the
        exchanged winner table, the pushes into the local `b_pkt` block
        (with the route-once-per-hop evaluation) and the stats."""
        tb, cfg = self._tabs[s], self.cfg
        state, t, fl = c["state"], c["t"], c["fl"]
        NV, S, Q = tb.consts["NV"], cfg.buf_pkts, cfg.srcq_pkts
        vpc = cfg.vcs_per_class
        Ep, Ek, Tp = tb.Ep, tb.Ek, tb.Tp
        c0 = s * Ek
        won_ch = c["won_ch"]
        B = won_ch.shape[0]
        dev = won_ch.device
        i32 = torch.int32
        w = summed[0]
        wdest, witime = w[..., W_DEST], w[..., W_ITIME]
        wmis, wmeta, wcls = w[..., W_MIS], w[..., W_META], w[..., W_CLS]
        wvc, wovc = _winner_vc(wcls, c["occ_min"], c["occ_arg"], NV // vpc,
                               vpc)
        entered = (wmis >= 0) & (tb.ch_dst_wg == wmis)
        wmis = torch.where(entered, -1, wmis)
        push = won_ch & ~tb.is_ej_ch
        vc_oh = wvc[..., None] == tb.vc_iota
        whead = torch.where(vc_oh, state.b_head, 0).sum(-1, dtype=i32)
        wslot = (whead + wovc) % S

        # replicated pops from the winner table: a winning buffer row
        # (se, sv) or source row ts pops one; rows that pop nothing add at
        # the spare last entry
        is_buf, se, sv, ts = c["is_buf"], c["se"], c["sv"], c["ts"]
        lane = torch.arange(B, device=dev).view(B, 1)
        pb = won_ch & is_buf
        pop1 = torch.zeros(B * Ep * NV + 1, dtype=i32, device=dev)
        pop1.index_add_(0, torch.where(pb, (lane * Ep + se) * NV + sv,
                                       B * Ep * NV).reshape(-1),
                        pb.reshape(-1).to(i32))
        pop1 = pop1[:-1].view(B, Ep, NV)
        ps = won_ch & ~is_buf
        pop_s = torch.zeros(B * Tp + 1, dtype=i32, device=dev)
        pop_s.index_add_(0, torch.where(ps, lane * Tp + ts,
                                        B * Tp).reshape(-1),
                         ps.reshape(-1).to(i32))
        pop_s = pop_s[:-1].view(B, Tp)
        if c["reap"] is None:
            stranded, reaped = summed[1], state.stats.reaped
        else:
            stranded = summed[1]
            reaped = state.stats.reaped + summed[2]
            pop1 = pop1 + summed[3]
            pop_s = pop_s + summed[4]
        b_head = (state.b_head + pop1) % S
        b_count = state.b_count - pop1 + (push[..., None] & vc_oh).to(i32)
        s_head = (state.s_head + pop_s) % Q
        s_count = state.s_count - pop_s
        ch_busy = torch.where(won_ch, tb.ch_ser - 1,
                              torch.clamp(state.ch_busy - 1, min=0))

        # local pushes: the shard's slice of the winner table
        sl = slice(c0, c0 + Ek)
        push_l = push[:, sl]
        wdest_l, wmis_l, wmeta_l = wdest[:, sl], wmis[:, sl], wmeta[:, sl]
        if c["cached"]:
            out2, cls2, meta2 = tb.route_kernel(
                fl, tb.ch_dst[sl].expand(B, Ek), wdest_l, wmis_l, wmeta_l)
            tail = [out2.to(i32), cls2.to(i32), meta2.to(i32)]
        else:
            z = torch.zeros_like(wdest_l)
            tail = [z, z, z]
        new_rec = torch.stack(
            [wdest_l, witime[:, sl], wmis_l, wmeta_l,
             (t + tb.ch_lat[sl]).expand(B, Ek)] + tail, dim=-1)
        store = with_sink_row(state.b_pkt)          # [B, Ek+1, NV, S, F]
        spread = tb.ek_iota % (NV * S)
        flat = (((lane * (Ek + 1) + torch.where(push_l, tb.ek_iota, Ek))
                 * NV + torch.where(push_l, wvc[:, sl], spread // S)) * S
                + torch.where(push_l, wslot[:, sl], spread % S))
        store.view(-1, new_rec.shape[-1]).index_copy_(
            0, flat.reshape(-1), new_rec.reshape(-1, new_rec.shape[-1]))

        st = state.stats
        w_ej = won_ch & tb.is_ej_ch
        hops = (won_ch[..., None] & tb.type_oh).sum(1, dtype=i32)
        lat = torch.where(w_ej, t - witime, 0).sum(-1, dtype=i32)
        st = st.replace(
            delivered=st.delivered + w_ej.sum(-1, dtype=i32),
            lat_sum=st.lat_sum + lat.to(torch.float32),
            hops=st.hops + hops, stranded=stranded, reaped=reaped,
            occ_peak=torch.maximum(st.occ_peak, c["occ"]))
        return state.replace(
            b_head=b_head, b_count=b_count, s_head=s_head, s_count=s_count,
            ch_busy=ch_busy, stats=st)
