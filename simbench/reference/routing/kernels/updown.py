"""Switch-less up*/down* route kernels: W-group-wide up*/down* routing over
the per-W-group rank/next-hop tables of `fl` (rebuilt on the surviving
subgraph when faulted).  2 VCs minimal / 3 non-minimal ("updown"), or
2 VCs with misroutes restricted to W-groups below the destination
("updown_merged").

Plain tensor gathers."""
from __future__ import annotations

import torch

from ...tensors import as_tensor, lane_take, take
from ...topology import EJECT, GLOBAL, Network
from ..vcs import PHASE_BIT, meta_g_count, meta_update


def make_updown_kernel(net: Network, vc_mode: str, device):
    """kernel(fl, cur, dest_term, mis_wg, meta) -> (out_ch, req_vc, meta')
    over ``[B, N]`` row tensors and a lane-stacked `fl`."""
    t = net.tables
    d = lambda x: as_tensor(x, device)
    node_wg = d(t["node_wg"])
    node_mesh_ch = d(t["node_mesh_ch"])
    eject_ch = d(t["eject_ch"])
    ext_out = d(t["ext_out"])
    local_port = d(t["local_port"])
    glob_route_cg = d(t["glob_route_cg"])
    glob_route_port = d(t["glob_route_port"])
    port_node_local = d(t["port_node_local"])
    term_node = d(t["term_node"])
    ch_type = d(net.ch_type)
    R = net.meta["R"]
    npc = net.meta["nodes_per_cg"]
    ab = net.meta["ab"]
    NW = ab * npc
    merged = vc_mode == "updown_merged"

    def route_vc(fl, cur, dest_term, mis_wg, meta):
        rank, nh = fl["ud_rank"], fl["ud_nh"]
        dest_node = take(term_node, dest_term)
        wg_c = take(node_wg, cur)
        wg_d = take(node_wg, dest_node)
        mis_active = mis_wg >= 0
        tgt_wg = torch.where(mis_active, mis_wg, wg_d)
        in_final = (wg_c == wg_d) & (~mis_active)
        u = cur % NW

        cnt = lane_take(fl["glob_cnt"], wg_c, tgt_wg)
        par = lane_take(fl["glob_idx"], wg_c, tgt_wg, dest_term % cnt)
        cg_gl = take(glob_route_cg, wg_c, tgt_wg, par)
        port_gl = take(glob_route_port, wg_c, tgt_wg, par)
        v_exit = cg_gl * npc + take(port_node_local, port_gl)
        v = torch.where(in_final, dest_node % NW, v_exit)
        arrived = u == v
        out_arr = torch.where(in_final, take(eject_ch, cur),
                              take(ext_out, wg_c * ab + cg_gl, port_gl))

        phase = (meta >> 6) & 1
        # warm-fault recovery exactly as the reference: a lost down-only
        # continuation restarts on phase 0; with no path at all the packet
        # strands on the -1 non-channel, which arbitration never grants
        nh_uv = lane_take(nh, wg_c, u, v)                  # [..., 2]
        w_ph = torch.where(phase == 1, nh_uv[..., 1], nh_uv[..., 0])
        restart = w_ph < 0
        w = torch.where(restart, nh_uv[..., 0], w_ph)
        phase = torch.where(restart, 0, phase)
        stranded = w < 0
        w = torch.clamp(w, min=0)                  # safe gather index only
        same_cg = (u // npc) == (w // npc)
        ux, uy = (u % npc) % R, (u % npc) // R
        wx, wy = (w % npc) % R, (w % npc) // R
        dir_idx = torch.where(wy < uy, 0, torch.where(
            wx > ux, 1, torch.where(wy > uy, 2, 3)))
        out_mesh = take(node_mesh_ch, cur, dir_idx)
        out_local = take(ext_out, wg_c * ab + u // npc,
                         take(local_port, u // npc, w // npc))
        out_step = torch.where(same_cg, out_mesh, out_local)
        out_ch = torch.where(arrived, out_arr, out_step)
        out_ch = torch.where(stranded & ~arrived, -1, out_ch)

        otype = take(ch_type, out_ch)
        new_meta = meta_update(meta, otype)
        went_down = phase | (lane_take(rank, wg_c, w)
                             > lane_take(rank, wg_c, u))
        new_phase = torch.where(otype == GLOBAL, 0,
                                torch.where(arrived, phase, went_down))
        new_meta = (new_meta & ~PHASE_BIT) | (new_phase.to(torch.int32) << 6)

        g = meta_g_count(new_meta)
        req_vc = torch.clamp(g, max=1 if merged else 2)
        req_vc = torch.where(otype == EJECT, 0, req_vc)
        return out_ch, req_vc.to(torch.int32), new_meta

    return route_vc
