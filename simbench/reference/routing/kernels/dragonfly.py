"""Switch-based Dragonfly route kernel (the paper's baseline, Kim et al.
2008): minimal l-g-l with optional Valiant group misroute; per-hop VC
increment.

Plain tensor gathers."""
from __future__ import annotations

import torch

from ...tensors import as_tensor, lane_take, take
from ...topology import EJECT, Network
from ..vcs import meta_cg_count, meta_update


def make_dragonfly_kernel(net: Network, device):
    """kernel(fl, cur, dest_term, mis_wg, meta) -> (out_ch, req_vc, meta')
    over ``[B, N]`` row tensors and a lane-stacked `fl`."""
    t = net.tables
    d = lambda x: as_tensor(x, device)
    node_grp = d(t["node_grp"])
    node_idx = d(t["node_idx"])
    local_ch = d(t["local_ch"])
    glob_route_sw = d(t["glob_route_sw"])
    glob_out_ch = d(t["glob_out_ch"])
    eject_sw_term = d(t["eject_sw_term"])
    term_node = d(t["term_node"])
    term_slot = d(t["term_slot"])
    ch_type = d(net.ch_type)

    def route_vc(fl, cur, dest_term, mis_wg, meta):
        dest_sw = take(term_node, dest_term)
        grp_c = take(node_grp, cur)
        grp_d = take(node_grp, dest_sw)
        mis_active = mis_wg >= 0
        tgt_grp = torch.where(mis_active, mis_wg, grp_d)

        at_dest_sw = (cur == dest_sw) & (~mis_active)
        cnt = lane_take(fl["glob_cnt"], grp_c, tgt_grp)
        par = lane_take(fl["glob_idx"], grp_c, tgt_grp, dest_term % cnt)
        sw_gl = take(glob_route_sw, grp_c, tgt_grp, par)
        in_tgt = grp_c == tgt_grp
        peer_sw = torch.where(in_tgt, dest_sw, sw_gl)
        use_global = (~in_tgt) & (cur == sw_gl)

        out_ch = torch.where(
            at_dest_sw,
            take(eject_sw_term, cur, take(term_slot, dest_term)),
            torch.where(use_global, take(glob_out_ch, grp_c, tgt_grp, par),
                        take(local_ch, cur, take(node_idx, peer_sw))))
        otype = take(ch_type, out_ch)
        new_meta = meta_update(meta, otype)
        req_vc = meta_cg_count(new_meta)  # per-hop increment scheme
        req_vc = torch.where(otype == EJECT, 0, req_vc)
        return out_ch, req_vc.to(torch.int32), new_meta

    return route_vc
