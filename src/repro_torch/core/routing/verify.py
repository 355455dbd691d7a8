"""Offline verification: path tracing, the channel-dependency graph, and
the deadlock-freedom proofs — per fault set and per epoch of a
`FaultSchedule`.

Port of `repro.core.routing.verify`.  The hop walk drives the port's
route closure (`make_route_fn`) on int32 tensors on an explicit device,
one call a hop; the channel-dependency graph (CDG) and its cycle check
are numpy (`ChannelDependencyGraph`), so the proofs need no graph
library.  With the same `rng` the port draws the reference's flows and
reaches the reference's verdicts and edge counts.

Device rule: like every entry point of the port, the proofs run on CUDA
unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import numpy as np
import torch

from ...device import resolve_device
from ..topology import EJECT, FaultSchedule, FaultSet, Network
from .pipeline import make_route_fn
from .vcs import PHASE_BIT


def trace_paths(net: Network, route_fn, src_terms: np.ndarray,
                dst_terms: np.ndarray, mis_wgs: np.ndarray,
                max_hops: int | None = None,
                start_nodes: np.ndarray | None = None,
                meta0: np.ndarray | None = None, *, device=None):
    """Walk packets hop-by-hop with no contention.

    `route_fn` is a `make_route_fn` closure bound to `device`; each hop
    calls it once on ``[1, B]`` int32 tensors there.  `start_nodes` /
    `meta0` resume packets mid-flight: the walk starts at an arbitrary
    router with an arbitrary routing-meta bitfield instead of fresh
    (meta 0) at `src_terms`' routers — the epoch-transition proofs use
    this to model packets in flight across a table swap.

    Returns (channels [B, H], vcs [B, H], lengths [B]) with -1 padding.
    """
    device = resolve_device(device)
    B = len(src_terms)
    if max_hops is None:
        R = net.meta.get("R", 2)
        max_hops = 8 * (4 * R + 4) + 16
    term_node = net.term_node
    node_wg_tbl = net.tables.get("node_wg", net.tables.get("node_grp"))
    ch_dst = net.ch_dst
    ch_typ = net.ch_type

    def step(cur, dst, mis, meta):
        args = (torch.as_tensor(np.asarray(x, dtype=np.int32))[None].to(
            device) for x in (cur, dst, mis, meta))
        return [x[0].cpu().numpy() for x in route_fn(*args)]

    cur = (term_node[src_terms].copy() if start_nodes is None
           else np.asarray(start_nodes, dtype=np.int64).copy())
    meta = (np.zeros(B, dtype=np.int32) if meta0 is None
            else np.asarray(meta0, dtype=np.int32).copy())
    mis = mis_wgs.astype(np.int32).copy()
    # misroute is pointless/undefined if src and dst share the W-group
    same = node_wg_tbl[cur] == node_wg_tbl[term_node[dst_terms]]
    mis = np.where(same, -1, mis)
    done = np.zeros(B, dtype=bool)
    chans = np.full((B, max_hops), -1, dtype=np.int64)
    vcs = np.full((B, max_hops), -1, dtype=np.int32)
    for hstep in range(max_hops):
        if done.all():
            break
        out_ch, vc, new_meta = step(cur, dst_terms, mis, meta)
        act = ~done
        chans[act, hstep] = out_ch[act]
        vcs[act, hstep] = vc[act]
        nxt = ch_dst[out_ch]
        is_eject = ch_typ[out_ch] == EJECT
        # clear mis on entering the intermediate W-group
        entered_mis = (mis >= 0) \
            & (node_wg_tbl[np.clip(nxt, 0, net.num_nodes - 1)] == mis) \
            & ~is_eject
        mis = np.where(act & entered_mis, -1, mis)
        meta = np.where(act, new_meta, meta)
        cur = np.where(act & ~is_eject, nxt, cur)
        done = done | (act & is_eject)
    if not done.all():
        bad = np.where(~done)[0][:5]
        raise RuntimeError(
            f"paths did not terminate within {max_hops} hops; e.g. "
            f"src={src_terms[bad]}, dst={dst_terms[bad]}, mis={mis_wgs[bad]}")
    lengths = (chans >= 0).sum(axis=1)
    return chans, vcs, lengths


class ChannelDependencyGraph:
    """A CDG over (channel, vc) pairs as a numpy edge list: `edges` holds
    the unique ``(c0, v0, c1, v1)`` rows, sorted."""

    def __init__(self, edges: np.ndarray):
        self.edges = np.asarray(edges, dtype=np.int64).reshape(-1, 4)

    def number_of_edges(self) -> int:
        return len(self.edges)

    def _nodes(self):
        """(node ids, src ids [M], dst ids [M]) over the edge list."""
        e = self.edges
        width = int(e[:, [1, 3]].max()) + 1 if len(e) else 1
        keys = np.concatenate([e[:, 0] * width + e[:, 1],
                               e[:, 2] * width + e[:, 3]])
        nodes, inv = np.unique(keys, return_inverse=True)
        M = len(e)
        return nodes, inv[:M], inv[M:]

    def _peel(self):
        """Kahn's algorithm a layer at a time: (removed [n], edges left
        [M], src, dst).  Nodes left over lie on or behind a cycle."""
        nodes, src, dst = self._nodes()
        n = len(nodes)
        indeg = np.bincount(dst, minlength=n)
        left = np.ones(len(src), dtype=bool)
        removed = np.zeros(n, dtype=bool)
        while True:
            frontier = ~removed & (indeg == 0)
            if not frontier.any():
                break
            removed |= frontier
            gone = left & frontier[src]
            indeg -= np.bincount(dst[gone], minlength=n)
            left &= ~gone
        return removed, left, src, dst

    def is_acyclic(self) -> bool:
        return bool(self._peel()[0].all())

    def find_cycle(self) -> list:
        """One cycle as a list of ``((c, v), (c', v'))`` edges, or [] when
        the graph is acyclic.  Every node Kahn's algorithm leaves has a
        predecessor among the left nodes, so walking predecessors must
        revisit a node."""
        removed, left, src, dst = self._peel()
        if removed.all():
            return []
        pred = np.full(len(removed), -1, dtype=np.int64)
        pred[dst[left]] = src[left]
        edge_of = {}
        for i in np.flatnonzero(left):
            edge_of[(int(src[i]), int(dst[i]))] = tuple(self.edges[i])
        node = int(np.flatnonzero(~removed)[0])
        seen = {}
        walk = []
        while node not in seen:
            seen[node] = len(walk)
            walk.append(node)
            node = int(pred[node])
        loop = walk[seen[node]:][::-1]      # forward order
        out = []
        for a, b in zip(loop, loop[1:] + loop[:1]):
            c0, v0, c1, v1 = edge_of[(a, b)]
            out.append(((int(c0), int(v0)), (int(c1), int(v1))))
        return out


def build_cdg(chans: np.ndarray, vcs: np.ndarray) -> ChannelDependencyGraph:
    """Channel-dependency graph over (channel, vc) pairs from traced paths."""
    c0, v0 = chans[:, :-1], vcs[:, :-1]
    c1, v1 = chans[:, 1:], vcs[:, 1:]
    valid = (c0 >= 0) & (c1 >= 0)
    cols = [x[valid].astype(np.int64) for x in (c0, v0, c1, v1)]
    if not len(cols[0]):
        return ChannelDependencyGraph(np.zeros((0, 4), dtype=np.int64))
    # one int64 key a row (mixed radix, lexicographic like the rows), so
    # the unique sort is over scalars
    C = max(int(cols[0].max()), int(cols[2].max())) + 1
    V = max(int(cols[1].max()), int(cols[3].max())) + 1
    key = np.unique(((cols[0] * V + cols[1]) * C + cols[2]) * V + cols[3])
    key, v1 = np.divmod(key, V)
    key, c1 = np.divmod(key, C)
    c0, v0 = np.divmod(key, V)
    return ChannelDependencyGraph(np.stack([c0, v0, c1, v1], axis=1))


def _assert_acyclic(cdg: ChannelDependencyGraph, what: str) -> int:
    if not cdg.is_acyclic():
        raise AssertionError(f"CDG cycle {what}: {cdg.find_cycle()[:12]}")
    return cdg.number_of_edges()


def assert_deadlock_free(net: Network, vc_mode: str, nonminimal: bool,
                         rng: np.random.Generator, n_pairs: int = 4000,
                         exhaustive_limit: int = 250_000,
                         faults: FaultSet | None = None, *,
                         device=None) -> int:
    """Trace flows and assert the CDG is acyclic.  Returns #edges checked.

    With `faults`, flows run between alive terminals on the degraded
    network; the trace additionally asserts no path crosses a dead channel
    (re-proving deadlock freedom AND fault avoidance on the survivors).
    """
    device = resolve_device(device)
    route_fn = make_route_fn(net, vc_mode, faults, device=device)
    T = net.num_terminals
    terms = (np.arange(T) if faults is None
             else np.flatnonzero(faults.term_alive(net)))
    TA = len(terms)
    if TA * TA <= exhaustive_limit and not nonminimal:
        si, di = np.divmod(np.arange(TA * TA), TA)
        s, d = terms[si], terms[di]
        keep = s != d
        s, d = s[keep], d[keep]
    else:
        s = terms[rng.integers(0, TA, size=n_pairs)]
        d = terms[rng.integers(0, TA, size=n_pairs)]
        keep = s != d
        s, d = s[keep], d[keep]
    if nonminimal:
        wg_tbl = net.tables.get("node_wg", net.tables.get("node_grp"))
        g = int(wg_tbl.max()) + 1
        wg_s = wg_tbl[net.term_node[s]]
        wg_d = wg_tbl[net.term_node[d]]
        if vc_mode == "updown_merged":
            # misroute only to W-groups strictly below the destination
            hi = np.maximum(wg_d, 1)
            mis = rng.integers(0, hi)
            bad = (mis == wg_s) | (mis == wg_d) | (wg_d == 0)
            mis = np.where(bad, -1, mis)
        else:
            mis = rng.integers(0, g, size=len(s))
            bad = (mis == wg_s) | (mis == wg_d)
            mis = np.where(bad, -1, mis)
    else:
        mis = np.full(len(s), -1, dtype=np.int64)
    chans, vcs, _ = trace_paths(net, route_fn, s, d, mis, device=device)
    if faults is not None:
        alive = faults.ch_alive(net)
        used = chans[chans >= 0]
        if not alive[used].all():
            bad = np.unique(used[~alive[used]])
            raise AssertionError(
                f"faulted routing crossed dead channels {bad[:8]} "
                f"({net.name}, vc_mode={vc_mode})")
    return _assert_acyclic(
        build_cdg(chans, vcs),
        f"for {net.name} vc_mode={vc_mode} nonmin={nonminimal}")


def assert_transition_safe(net: Network, vc_mode: str, nonminimal: bool,
                           rng: np.random.Generator,
                           prev_faults: FaultSet, next_faults: FaultSet,
                           n_pairs: int = 2000, *, device=None) -> int:
    """Prove one epoch transition safe for packets already in flight.

    A packet crossing an epoch boundary keeps its routing meta but
    resumes on the NEW epoch's tables.  Besides fresh flows of the next
    epoch this traces RESUMED packets — parked at a router both epochs
    kept, down-phase bit set, one global hop banked — and asserts that
    every resume terminates, that none crosses a channel dead in the next
    epoch, and that the CDG over fresh and resumed flows together is
    acyclic (see the reference for the argument).  Returns the combined
    CDG edge count.
    """
    device = resolve_device(device)
    route_fn = make_route_fn(
        net, vc_mode, None if next_faults.is_empty else next_faults,
        device=device)
    nodes_both = np.flatnonzero(prev_faults.node_alive(net)
                                & next_faults.node_alive(net))
    terms_next = np.flatnonzero(next_faults.term_alive(net))
    if len(nodes_both) == 0 or len(terms_next) == 0:
        return 0
    # fresh flows of the next epoch (meta 0, injected at alive terminals)
    s = terms_next[rng.integers(0, len(terms_next), size=n_pairs)]
    d = terms_next[rng.integers(0, len(terms_next), size=n_pairs)]
    keep = s != d
    s, d = s[keep], d[keep]
    mis = np.full(len(s), -1, dtype=np.int64)
    chans_f, vcs_f, _ = trace_paths(net, route_fn, s, d, mis, device=device)
    # resumed flows: parked mid-walk at a router both epochs kept, with
    # the down-phase bit set and one global + one external hop banked
    u = nodes_both[rng.integers(0, len(nodes_both), size=n_pairs)]
    dr = terms_next[rng.integers(0, len(terms_next), size=n_pairs)]
    keep = net.term_node[dr] != u
    if vc_mode == "updown_merged":
        # only REACHABLE resumed states: a packet with its global hop
        # banked outside its destination W-group sits at or below it
        wg_tbl = net.tables.get("node_wg", net.tables.get("node_grp"))
        keep &= wg_tbl[u] <= wg_tbl[net.term_node[dr]]
    u, dr = u[keep], dr[keep]
    meta0 = np.full(len(u), PHASE_BIT | (1 << 3) | 1, dtype=np.int32)
    chans_r, vcs_r, _ = trace_paths(
        net, route_fn, dr, dr, np.full(len(u), -1, dtype=np.int64),
        start_nodes=u, meta0=meta0, device=device)
    alive = next_faults.ch_alive(net)
    used = chans_r[chans_r >= 0]
    if not alive[used].all():
        bad = np.unique(used[~alive[used]])
        raise AssertionError(
            f"resumed packets crossed dead channels {bad[:8]} after the "
            f"epoch swap ({net.name}, vc_mode={vc_mode})")
    H = max(chans_f.shape[1], chans_r.shape[1])
    pad = lambda a: np.pad(a, ((0, 0), (0, H - a.shape[1])),
                           constant_values=-1)
    cdg = build_cdg(np.concatenate([pad(chans_f), pad(chans_r)]),
                    np.concatenate([pad(vcs_f), pad(vcs_r)]))
    return _assert_acyclic(
        cdg, f"across epoch transition for {net.name} vc_mode={vc_mode}")


def assert_schedule_deadlock_free(net: Network, vc_mode: str,
                                  nonminimal: bool,
                                  rng: np.random.Generator,
                                  schedule: FaultSchedule,
                                  n_pairs: int = 4000,
                                  check_transitions: bool = True, *,
                                  device=None) -> list:
    """`assert_deadlock_free` re-proven for EVERY epoch of a warm-fault
    schedule; with `check_transitions` (the default) every adjacent pair
    of distinct epochs is also proven safe for packets in flight across
    the swap (`assert_transition_safe`).  Returns the per-epoch CDG edge
    counts."""
    device = resolve_device(device)
    edges = []
    for cycle, faults in schedule.epochs:
        edges.append(assert_deadlock_free(
            net, vc_mode, nonminimal, rng, n_pairs=n_pairs,
            faults=None if faults.is_empty else faults, device=device))
    if check_transitions:
        for (_, prev), (_, nxt) in zip(schedule.epochs,
                                       schedule.epochs[1:]):
            if prev == nxt:
                continue    # static schedule: nothing swaps
            assert_transition_safe(net, vc_mode, nonminimal, rng,
                                   prev, nxt,
                                   n_pairs=max(200, n_pairs // 4),
                                   device=device)
    return edges
