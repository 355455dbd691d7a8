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
reports the form the reference would compile.

The compact step first compacts the live rows (non-empty (channel, VC)
buffers, then non-empty source queues, in the oracle's row order) into an
active set of C slots, so request assembly and arbitration run over C
rows instead of ``N = E_req * NV + T``.  Each slot's grant priority is
its GLOBAL row id, so every tie resolves as in the oracle.  Whether C
bounded the live set is certified by the exact census folded into
`SimStats.occ_peak`; the sweep re-runs the grid at the next rung of the
capacity ladder when it did not (`sweep._PendingLanes.finish`).

Every tensor carries the leading lane dimension ``B``.  Channel sharding
(the reference's `_make_sharded`) is not ported.
"""
from __future__ import annotations

import torch

from ... import env_int
from ...kernels.netsim import ops as netsim_ops
from ...tensors import lane_take, take
from ..routing import num_vcs
from ..topology import EJECT, NUM_CH_TYPES, Network
from ..traffic import as_pattern
from .inject import make_inject_fn
from .state import (F_CLS, F_DEST, F_ITIME, F_META, F_META2, F_MIS, F_OUT,
                    F_READY, INF32, build_consts, is_scheduled,
                    resolve_device, resolve_epoch, resolve_reap_age,
                    with_sink_row)
from .stats import live_rows

# winner-record columns: destination, generation cycle, misroute wg,
# meta-to-store, class
W_DEST, W_ITIME, W_MIS, W_META, W_CLS = range(5)


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def grant_form(net: Network, cfg) -> str:
    """The grant form the REFERENCE's unsharded fused and compact steps
    compile for this (net, cfg): ``"combined"`` — one packed
    ``itime * R2 + prio`` segment-min — or ``"two_pass"``, its fallback
    when the packed key could exceed int32 (``cycles * R2 + R2 - 1``).
    The port's kernel serves both with one 64-bit key; this is reporting
    only."""
    R2 = _pow2(compact_rows(net, cfg))
    cycles = cfg.warmup + cfg.measure
    return ("combined" if cycles * R2 + (R2 - 1) < 2**31 - 1
            else "two_pass")


def make_fused_step(net: Network, cfg, pattern, inject_mask=None, *,
                    shards: int = 1, device=None):
    """Returns (step, consts); signature-compatible with `step.make_step`.
    ``shards > 1`` (the reference's channel-sharded variant) raises
    NotImplementedError."""
    if shards > 1:
        raise NotImplementedError(
            "channel sharding of the fused step is multi-device "
            "placement, not ported to repro_torch yet (ROADMAP.md queue "
            "1, item 7)")
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
        fl = resolve_epoch(fl, t)
        state = inject(state, t, key, rate_pkt, fl)
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
                    clamp=False)                                 # [B, C, 8]
        srec = take(state.s_pkt, lane, tt, lane_take(state.s_head, tt),
                    clamp=False)                                 # [B, C, 3]
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
        occ_min, occ_arg = _occ_tables(state.b_count, NC, vpc)
        elig_ck = (occ_min < S) | tb.is_ej_ch[:, None]
        ok = rowok & _row_elig(elig_ck, out, cls, E)
        ch_ok = (state.ch_busy == 0) & fl["ch_alive"]
        won_ch, wprio, win_slot = netsim_ops.cycle_core(
            out, itime, ok, ch_ok, r2=R2, prio=aid)

        # dense winner table: each granting channel's winning row id
        # back to its active slot (aid is sorted: one binary search)
        wslot_i = torch.searchsorted(aid, wprio, out_int32=True).clamp(
            0, C - 1)
        crec = torch.stack([dest, itime, mis, meta2, cls], dim=-1)
        w = lane_take(crec, wslot_i)                              # [B, E, 5]
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
    e_idx = torch.arange(ER, device=dev).view(1, ER, 1)
    v_idx = torch.arange(NV, device=dev).view(1, 1, NV)
    t_idx = torch.arange(T, device=dev)

    def step(state, t_key_rate_fl):
        t, key, rate_pkt, fl = t_key_rate_fl
        cached = not is_scheduled(fl)
        fl = resolve_epoch(fl, t)
        state = inject(state, t, key, rate_pkt, fl)
        occ = live_rows(state)
        B = state.b_head.shape[0]

        # request rows in the oracle's order ([:ER]*NV buffer heads, then
        # T source queues); the row index IS the oracle's tie-break
        lane3 = torch.arange(B, device=dev).view(B, 1, 1)
        head = take(with_sink_row(state.b_pkt), lane3, e_idx, v_idx,
                    state.b_head[:, :ER], clamp=False).reshape(
                        B, ER * NV, -1)
        r_valid = ((state.b_count[:, :ER] > 0).reshape(B, -1)
                   & (head[..., F_READY] <= t))
        if cached:
            out_b, cls_b, meta2_b = (head[..., F_OUT], head[..., F_CLS],
                                     head[..., F_META2])
        else:
            out_b, cls_b, meta2_b = route_kernel(
                fl, cur_rows.expand(B, -1), head[..., F_DEST],
                head[..., F_MIS], head[..., F_META])
        sq = take(state.s_pkt, lane3[..., 0], t_idx, state.s_head,
                  clamp=False)                                   # [B, T, 3]
        out = torch.cat([out_b, tb.inject_ch.expand(B, T)], 1).to(
            torch.int32)
        cls = torch.cat([cls_b, torch.zeros_like(sq[..., 0])], 1).to(
            torch.int32)
        itime = torch.cat([head[..., F_ITIME], sq[..., F_ITIME]], 1)
        valid = torch.cat([r_valid, state.s_count > 0], 1)
        rowok = valid & (out >= 0)
        undel, reap = _reap(reap_age, valid, out, itime, fl, t, E)

        # grant: per-row credit gather, then the arbitration core
        occ_min, occ_arg = _occ_tables(state.b_count, NC, vpc)
        elig_ck = (occ_min < S) | tb.is_ej_ch[:, None]
        ok = rowok & _row_elig(elig_ck, out, cls, E)
        ch_ok = (state.ch_busy == 0) & fl["ch_alive"]
        won_ch, wprio, win_row = netsim_ops.cycle_core(out, itime, ok,
                                                       ch_ok, r2=R2)

        # dense winner table: two E-row gathers (buffer / source rows)
        is_buf = wprio < ER * NV
        bclip = wprio.clamp(0, ER * NV - 1)
        wb = lane_take(head, bclip)
        ws = lane_take(sq, (wprio - ER * NV).clamp(0, T - 1))
        if cached:
            wmeta, wcls = wb[..., F_META2], wb[..., F_CLS]
        else:
            wmeta, wcls = lane_take(meta2_b, bclip), lane_take(cls_b, bclip)
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
