"""Switch-less Dragonfly baseline route kernel: Alg. 1 with XY in-C-group
routing; VC = #C-groups entered (4 VCs minimal / 6 non-minimal).

A plain tensor gather pipeline."""
from __future__ import annotations

import torch

from ...tensors import as_tensor, lane_take, take
from ...topology import EJECT, Network
from ..vcs import meta_cg_count, meta_update


def make_baseline_kernel(net: Network, device):
    """kernel(fl, cur, dest_term, mis_wg, meta) -> (out_ch, req_vc, meta')
    over ``[B, N]`` row tensors and a lane-stacked `fl`."""
    t = net.tables
    d = lambda x: as_tensor(x, device)
    node_wg = d(t["node_wg"])
    node_cg = d(t["node_cg"])
    node_cgg = d(t["node_cg_global"])
    node_x = d(t["node_x"])
    node_y = d(t["node_y"])
    node_mesh_ch = d(t["node_mesh_ch"])
    eject_ch = d(t["eject_ch"])
    ext_out = d(t["ext_out"])
    local_port = d(t["local_port"])
    port_node_local = d(t["port_node_local"])
    term_node = d(t["term_node"])
    ch_type = d(net.ch_type)
    R = net.meta["R"]
    nodes_per_cg = net.meta["nodes_per_cg"]
    dnode_tbl = torch.stack([node_wg, node_cgg, node_cg], dim=-1)  # [V, 3]
    glob_tbl = torch.stack([d(t["glob_route_cg"]),
                            d(t["glob_route_port"])], dim=-1)

    def route_vc(fl, cur, dest_term, mis_wg, meta):
        dest_node = take(term_node, dest_term)
        dtbl = take(dnode_tbl, dest_node)
        wg_c = take(node_wg, cur)
        wg_d = dtbl[..., 0]
        mis_active = mis_wg >= 0
        tgt_wg = torch.where(mis_active, mis_wg, wg_d)
        cg_c = take(node_cg, cur)
        cgg_c = take(node_cgg, cur)
        cgg_d = dtbl[..., 1]
        cg_d = dtbl[..., 2]

        in_tgt_wg = wg_c == tgt_wg          # mis cleared on entry => == wg_d
        at_dest_cg = (cgg_c == cgg_d) & (~mis_active)

        # exit port selection (Alg. 1 steps); parallel global links per
        # W-group pair are spread across flows by destination hash over the
        # ALIVE links (fl re-picks around dead parallel globals)
        cnt = lane_take(fl["glob_cnt"], wg_c, tgt_wg)
        par = lane_take(fl["glob_idx"], wg_c, tgt_wg, dest_term % cnt)
        gtbl = take(glob_tbl, wg_c, tgt_wg, par)
        cg_gl = gtbl[..., 0]                         # owner of global channel
        port_gl = gtbl[..., 1]
        at_global_cg = cg_c == cg_gl
        peer_cg = torch.where(in_tgt_wg, cg_d, cg_gl)
        port_lc = take(local_port, cg_c, peer_cg)
        use_global = (~in_tgt_wg) & at_global_cg
        port = torch.where(use_global, port_gl, port_lc)
        to_terminal = at_dest_cg

        tgt_local = torch.where(to_terminal, dest_node % nodes_per_cg,
                                take(port_node_local, port))
        cur_local = cur % nodes_per_cg
        at_target = cur_local == tgt_local
        out_at_target = torch.where(to_terminal, take(eject_ch, cur),
                                    take(ext_out, cgg_c, port))

        # XY (dimension-order): x first, then y.  DIRS = (N, E, S, W).
        tx = tgt_local % R
        ty = tgt_local // R
        x = take(node_x, cur)
        y = take(node_y, cur)
        dir_xy = torch.where(x != tx, torch.where(tx > x, 1, 3),
                             torch.where(ty > y, 2, 0))
        out_mesh = take(node_mesh_ch, cur, dir_xy)

        out_ch = torch.where(at_target, out_at_target, out_mesh)
        otype = take(ch_type, out_ch)
        new_meta = meta_update(meta, otype)
        req_vc = torch.where(otype == EJECT, 0, meta_cg_count(new_meta))
        return out_ch, req_vc.to(torch.int32), new_meta

    return route_vc
