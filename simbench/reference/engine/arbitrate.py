"""Arbitration phase: gather per-(channel, VC) and per-source-queue
requesters, route them, expand deadlock class to physical VC, apply
credit/busy constraints, and grant one winner per output channel by
age-based (oldest-first) arbitration.

The request rows are ordered
[E_req*NV buffer heads, then T source queues] per lane (``[B, N]``);
`win[:, :E_req*NV]` / `win[:, E_req*NV:]` is the contract the apply phase
relies on.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ..grant import grant_ref
from ..tensors import lane_take, take
from ..topology import EJECT, Network
from .state import (F_DEST, F_ITIME, F_META, F_MIS, F_READY, SimState,
                    with_sink_row)

@dataclass
class Requests:
    """One row per potential packet movement this cycle ([B, E_req*NV + T])."""

    dest: torch.Tensor       # destination terminal
    itime: torch.Tensor      # generation cycle (arbitration age key)
    mis: torch.Tensor        # misroute W-group (-1 = minimal)
    meta: torch.Tensor       # routing meta AFTER the requested hop
    out: torch.Tensor        # requested output channel
    vc: torch.Tensor         # requested downstream physical VC
    valid: torch.Tensor      # bool: the row holds a forwardable packet
    otype: torch.Tensor      # channel type of `out`
    odst_wg: torch.Tensor    # W-group of the downstream node of `out`
    olat: torch.Tensor       # pipeline latency of `out`
    ovc_count: torch.Tensor  # occupancy of the requested (out, vc) buffer

    def replace(self, **kw) -> "Requests":
        return replace(self, **kw)


def gather_requests(state: SimState, consts, route_kernel, fl,
                    t: int | torch.Tensor) -> Requests:
    """Head-of-line packets of every non-eject (channel, VC) buffer + source
    queue, routed through the lane's fault-dependent tables `fl`."""
    NV, T, ER = consts["NV"], consts["T"], consts["E_req"]
    B = state.b_head.shape[0]
    dev = state.b_head.device
    bh = state.b_head[:, :ER]                              # [B, E_req, NV]
    lane3 = torch.arange(B, device=dev).view(B, 1, 1)
    e_idx = torch.arange(ER, device=dev).view(1, ER, 1)
    v_idx = torch.arange(NV, device=dev).view(1, 1, NV)
    # ONE gather pulls the whole packed head record per (channel, VC)
    head_pkt = take(with_sink_row(state.b_pkt), lane3, e_idx, v_idx, bh,
                    clamp=False).reshape(B, ER * NV, -1)
    r_dest = head_pkt[..., F_DEST]
    r_itime = head_pkt[..., F_ITIME]
    r_mis = head_pkt[..., F_MIS]
    r_meta = head_pkt[..., F_META]
    r_ready = head_pkt[..., F_READY]
    r_valid = (state.b_count[:, :ER] > 0).reshape(B, -1) & (r_ready <= t)
    cur_node = consts["ch_dst"][:ER].repeat_interleave(NV).expand(B, -1)
    out_ch, req_vc, new_meta = route_kernel(fl, cur_node, r_dest, r_mis,
                                            r_meta)

    # source-queue requesters: fixed out channel (the injection link)
    lane2 = torch.arange(B, device=dev).view(B, 1)
    sq_pkt = take(state.s_pkt, lane2, torch.arange(T, device=dev),
                  state.s_head, clamp=False)
    zeros_t = torch.zeros((B, T), dtype=torch.int32, device=dev)
    out = torch.cat([out_ch, consts["inject_ch"].expand(B, T)],
                    dim=1).to(torch.int32)
    otbl = take(consts["ch_tbl"], out)                     # [B, N, 3]
    return Requests(
        dest=torch.cat([r_dest, sq_pkt[..., F_DEST]], dim=1),
        itime=torch.cat([r_itime, sq_pkt[..., F_ITIME]], dim=1),
        mis=torch.cat([r_mis, sq_pkt[..., F_MIS]], dim=1),
        meta=torch.cat([new_meta, zeros_t], dim=1),
        out=out,
        vc=torch.cat([req_vc, zeros_t], dim=1),
        valid=torch.cat([r_valid, state.s_count > 0], dim=1),
        otype=otbl[..., 0], odst_wg=otbl[..., 1], olat=otbl[..., 2],
        ovc_count=torch.zeros_like(out))


def expand_vcs(req: Requests, state: SimState, cfg) -> Requests:
    """Deadlock class -> physical VC: least-occupied VC of the class, the
    FIRST such VC on ties (the reference's `argmin`); also records the
    chosen buffer's occupancy (`ovc_count`)."""
    vpc = cfg.vcs_per_class
    if vpc <= 1:
        return req.replace(
            ovc_count=lane_take(state.b_count, req.out, req.vc))
    base = req.vc * vpc
    vc_idx = base[..., None] + torch.arange(vpc, dtype=torch.int32,
                                            device=base.device)
    occs = lane_take(state.b_count, req.out[..., None], vc_idx)  # [B, N, vpc]
    best, arg = occs[..., 0], torch.zeros_like(base)
    for j in range(1, vpc):
        better = occs[..., j] < best
        arg = torch.where(better, j, arg)
        best = torch.where(better, occs[..., j], best)
    return req.replace(vc=base + arg, ovc_count=best)


def make_arbitrate_fn(net: Network, cfg, consts, route_kernel):
    """Returns arbitrate(state, t, fl) -> (Requests, win_mask, won_ch_mask),
    the grant being the plain two-pass reduction (`grant.grant_ref`)."""

    def arbitrate(state, t, fl):
        req = gather_requests(state, consts, route_kernel, fl, t)
        req = expand_vcs(req, state, cfg)
        win, won_ch = grant_ref(
            req.out, req.itime, req.valid, req.ovc_count,
            req.otype == EJECT, state.ch_busy, fl["ch_alive"],
            buf_pkts=cfg.buf_pkts)
        return req, win, won_ch

    return arbitrate
