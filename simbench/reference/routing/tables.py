"""Fault-dependent routing tables (the `fl` dict the kernels read).

The tables are built in numpy on the
host, exactly as the reference builds them, and handed to the kernels as
device tensors: everything a fault can change lives in this dict, so the
engine can stack it over a lane axis (different fault sets per lane) or
an epoch axis (a `FaultSchedule`) and run every lane through one step.
"""
from __future__ import annotations

import numpy as np
import torch

from ..tensors import as_tensor
from ..topology import (FaultSet, FaultSchedule, LOCAL, MESH, Network,
                        validate_faults, wgroup_adjacency,
                        _wired_global_links)


def route_tables(net: Network, vc_mode: str = "baseline",
                 faults: FaultSet | None = None, *, device) -> dict:
    """Fault-dependent routing tables for ONE fault epoch.

    Always contains the parallel-global-link re-pick tables
    (`glob_cnt [g, g]`, `glob_idx [g, g, npar]`: flows spread over the
    ALIVE parallel links of each W-group pair by destination hash); for the
    up*/down* modes it adds the per-W-group tables recomputed on the
    surviving graph (`ud_rank [g, NW]`, `ud_nh [g, NW, NW, 2]`).
    """
    faults = faults or FaultSet()
    if not faults.is_empty:
        validate_faults(net, faults, vc_mode)
    ch_alive = faults.ch_alive(net)
    g = net.meta["g"]
    wired = _wired_global_links(net)                      # [g, g, npar]
    npar = wired.shape[-1]
    ok = (wired >= 0) & ch_alive[np.maximum(wired, 0)]
    cnt = ok.sum(-1)
    idx = np.zeros((g, g, npar), dtype=np.int64)
    for w in range(g):
        for u in range(g):
            alive = np.flatnonzero(ok[w, u])
            idx[w, u, :len(alive)] = alive
    fl = dict(glob_cnt=as_tensor(np.maximum(cnt, 1), device),
              glob_idx=as_tensor(idx, device))
    if net.meta["kind"] == "switchless" and vc_mode != "baseline":
        rank, nh = build_updown_tables(net, faults=faults)
        fl["ud_rank"] = as_tensor(rank, device)
        fl["ud_nh"] = as_tensor(nh, device)
    return fl


def stack_epoch_dicts(per_epoch: list, onset_cycles) -> tuple:
    """THE epoch-stacking primitive: one dict of tensors per epoch ->
    `(epoch_start [P] int32, stacked)` with a leading `[P, ...]` epoch
    axis on every tensor."""
    stacked = {k: torch.stack([d[k] for d in per_epoch])
               for k in per_epoch[0]}
    device = next(iter(stacked.values())).device
    starts = torch.tensor(list(onset_cycles), dtype=torch.int32,
                          device=device)
    return starts, stacked


def stack_epoch_tables(net: Network, vc_mode: str,
                       schedule: FaultSchedule, *, device) -> tuple:
    """Per-epoch routing tables of a `FaultSchedule`, stacked on axis 0:
    `(epoch_start [P] int32, tables)` with a leading `[P, ...]` axis."""
    return stack_epoch_dicts(
        [route_tables(net, vc_mode, f, device=device)
         for _, f in schedule.epochs],
        (c for c, _ in schedule.epochs))


# --- per-W-group up*/down* tables --------------------------------------------

def _updown_single(NW: int, nbrs, alive: np.ndarray):
    """up*/down* tables over ONE W-group graph restricted to alive routers.

    Autonet-style: rank routers by BFS (depth, id) from the lowest-id alive
    router; a channel u->w is *up* iff rank(w) < rank(u).  Legal paths take
    all up hops before any down hop, which makes the channel dependency
    graph acyclic for ANY (sub)graph.

    Returns (rank [NW], nh [NW, NW, 2]); dead routers keep the trailing
    ranks and -1 next-hops (they are never a source, hop, or target).
    """
    depth = np.full(NW, -1)
    root = int(np.flatnonzero(alive)[0])
    depth[root] = 0
    q = [root]
    while q:
        u = q.pop(0)
        for w, _ in nbrs[u]:
            if depth[w] < 0:
                depth[w] = depth[u] + 1
                q.append(w)
    assert (depth[alive] >= 0).all(), \
        "surviving W-group graph must be connected"
    # alive routers ordered by (depth, id); dead routers pushed to the end
    key = np.where(alive, depth, NW) * NW + np.arange(NW)
    rank = np.argsort(np.argsort(key))

    INF = 10**9
    f1 = np.full((NW, NW), INF, dtype=np.int64)   # down-phase distance
    nh1 = np.full((NW, NW), -1, dtype=np.int32)
    np.fill_diagonal(f1, 0)
    order_desc = np.argsort(-rank)
    for u in order_desc:
        for w, wt in nbrs[u]:
            if rank[w] > rank[u]:  # down edge
                cand = wt + f1[w]
                upd = cand < f1[u]
                f1[u][upd] = cand[upd]
                nh1[u][upd] = w
    f0 = f1.copy()
    nh0 = nh1.copy()
    order_asc = np.argsort(rank)
    for u in order_asc:
        for w, wt in nbrs[u]:
            if rank[w] < rank[u]:  # up edge
                cand = wt + f0[w]
                upd = cand < f0[u]
                f0[u][upd] = cand[upd]
                nh0[u][upd] = w
    live = np.ix_(alive, alive)
    assert (f0[live][~np.eye(int(alive.sum()), dtype=bool)] < INF).all(), \
        "up*/down* must connect all alive routers"
    nh = np.stack([nh0, nh1], axis=-1)
    return rank.astype(np.int32), nh


def build_updown_tables(net: Network, faults: FaultSet | None = None):
    """Per-W-group all-pairs up*/down* next-hop tables (numpy).

    Pristine W-groups share one table (computed once, tiled); W-groups
    touched by `faults` get their tables recomputed on the surviving
    subgraph.  Returns (rank [g, NW], nh [g, NW, NW, 2]) where
    nh[wg, u, v, phase] is the next wg-local router towards v (phase 1 =
    a down hop was already taken).
    """
    meta = net.meta
    ab, npc = meta["ab"], meta["nodes_per_cg"]
    g = meta["g"]
    NW = ab * npc
    faults = faults or FaultSet()
    touched = {int(r) // NW for r in faults.dead_routers}
    touched |= {int(net.ch_src[c]) // NW for c in faults.dead_ch
                if net.ch_type[c] in (MESH, LOCAL)}
    pristine_adj, _ = wgroup_adjacency(net, wgs=[0])
    base = _updown_single(NW, pristine_adj[0], np.ones(NW, dtype=bool))
    rank = np.repeat(base[0][None], g, axis=0)
    nh = np.repeat(base[1][None], g, axis=0)
    if touched:
        adj, alive = wgroup_adjacency(net, faults, wgs=touched)
        for wg in sorted(touched):
            rank[wg], nh[wg] = _updown_single(NW, adj[wg], alive[wg])
    return rank, nh


def share_lanes(fl: dict, B: int) -> dict:
    """One lane dict broadcast over `B` lanes without copying (stride-0
    views): the port's form of the reference's ``vmap(in_axes=None)``."""
    return {k: v.expand((B,) + tuple(v.shape)) for k, v in fl.items()}
