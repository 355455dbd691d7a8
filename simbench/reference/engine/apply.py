"""Apply phase: commit the granted movements — pop winners from their
buffers / source queues, push them into the downstream (channel, VC) buffer,
clear satisfied misroutes, stamp cut-through readiness, and charge channel
serialization.

Non-winners' pushes go to the spare row E that `state.make_state`
allocates behind `b_pkt` (`state.with_sink_row`), and `b_pkt` is written
in place.  A
non-winner may share a (channel, VC, slot) with a winner, so it must not
write anywhere a winner writes; the spare row is never read.
"""
from __future__ import annotations

import torch

from ..tensors import flat_index, lane_index, lane_take
from ..topology import EJECT, Network
from .arbitrate import Requests
from .state import SimState, with_sink_row


def make_apply_fn(net: Network, cfg, consts):
    E, NV, ER = consts["E"], consts["NV"], consts["E_req"]
    S, Q = cfg.buf_pkts, cfg.srcq_pkts

    def apply_moves(state: SimState, req: Requests, win, won_ch,
                    t: int | torch.Tensor, reap=None) -> SimState:
        B = win.shape[0]
        win_buf = win[:, :ER * NV].reshape(B, ER, NV)
        win_src = win[:, ER * NV:]
        # reaped rows pop exactly like winners but push nowhere and charge
        # no serialization (the two masks are disjoint)
        pop_buf = (win_buf if reap is None
                   else win_buf | reap[:, :ER * NV].reshape(B, ER, NV))
        pop_src = win_src if reap is None else win_src | reap[:, ER * NV:]
        pop_buf = pop_buf.to(torch.int32)
        pop_src = pop_src.to(torch.int32)

        # pops (the trailing eject rows never pop)
        b_head = torch.cat(
            [(state.b_head[:, :ER] + pop_buf) % S, state.b_head[:, ER:]], 1)
        b_count = torch.cat(
            [state.b_count[:, :ER] - pop_buf, state.b_count[:, ER:]], 1)
        s_head = (state.s_head + pop_src) % Q
        s_count = state.s_count - pop_src

        # pushes: one winner per out channel => no collisions among
        # winners; the slot uses the PRE-pop head/count of the destination
        # buffer (a pop there removes its head, not the tail we append to)
        w_push = win & (req.otype != EJECT)
        po = req.out
        pv = req.vc
        pslot = (lane_take(state.b_head, po, pv) + req.ovc_count) % S
        # clear misroute on entering the intermediate W-group
        entered = (req.mis >= 0) & (req.odst_wg == req.mis)
        new_mis = torch.where(entered, -1, req.mis)
        # virtual cut-through: the head is forwardable after the pipeline
        # latency; serialization is modeled by the channel busy time below
        ready = t + req.olat
        new_pkt = torch.stack([req.dest, req.itime, new_mis, req.meta, ready],
                              dim=-1)
        lane = torch.arange(B, device=win.device).view(B, 1)
        pv_w = torch.where(w_push, pv, 0)
        ps_w = torch.where(w_push, pslot, 0)
        store = with_sink_row(state.b_pkt)         # [B, E+1, NV, S, F]
        flat = flat_index(store.shape, (lane, torch.where(w_push, po, E),
                                        pv_w, ps_w), clamp=False)
        store.view(-1, new_pkt.shape[-1]).index_copy_(
            0, flat.reshape(-1), new_pkt.reshape(-1, new_pkt.shape[-1]))
        # non-winners add 0, each at its own position: one shared target
        # would serialise ~N atomic adds on the card
        spread = torch.arange(win.shape[1], device=win.device) \
            % b_count.numel()
        flat = torch.where(w_push, lane_index(b_count, (po, pv)), spread)
        b_count.view(-1).index_add_(0, flat.reshape(-1),
                                    w_push.reshape(-1).to(torch.int32))

        # channel busy (serialization) for every winner (incl. ejects);
        # ser - 1 because the winning cycle itself is the first busy slot
        ch_busy = torch.where(won_ch, consts["ch_ser"] - 1,
                              torch.clamp(state.ch_busy - 1, min=0))

        return state.replace(
            b_head=b_head, b_count=b_count,
            s_head=s_head, s_count=s_count, ch_busy=ch_busy)

    return apply_moves
