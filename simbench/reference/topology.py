"""Switch-less Dragonfly on Wafers: topology construction.

Implements the 5-level hierarchy of the paper (chiplet -> C-group -> wafer ->
W-group -> system) as a concrete router/channel graph, plus the traditional
switch-based Dragonfly baseline the paper compares against.

Construction is numpy; the simulator converts to tensors.  All channels are
directed.  Channel types:

  MESH   on-wafer short-reach hop inside a C-group (H_sr)
  LOCAL  intra-W-group C-group-to-C-group link (H_l, long-reach)
  GLOBAL inter-W-group link (H_g, long-reach)
  INJECT terminal -> router
  EJECT  router -> terminal

Channel-id layout contract: EJECT channels form the TRAILING id block
(checked by `Network.validate`).  Eject channels own no input buffers and
never appear as requesters, so the simulation engine shrinks its per-cycle
request grid to `[:first_eject]` with a free slice instead of a masked
gather (see engine/arbitrate.py).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np

MESH, LOCAL, GLOBAL, INJECT, EJECT = 0, 1, 2, 3, 4
CH_TYPE_NAMES = ("mesh", "local", "global", "inject", "eject")
NUM_CH_TYPES = 5


@dataclass
class Network:
    """A directed channel graph with terminals, consumed by the simulator."""

    name: str
    num_nodes: int
    num_terminals: int
    num_chips: int
    term_node: np.ndarray      # [T] router node hosting terminal t
    term_chip: np.ndarray      # [T] chip id of terminal t (for /chip rates)
    ch_src: np.ndarray         # [E]
    ch_dst: np.ndarray         # [E]
    ch_bw: np.ndarray          # [E] flits/cycle
    ch_lat: np.ndarray         # [E] cycles of pipeline latency
    ch_type: np.ndarray        # [E] MESH/LOCAL/GLOBAL/INJECT/EJECT
    inject_ch: np.ndarray      # [T] channel id terminal->router
    eject_ch: np.ndarray       # [V] channel id router->terminal (-1 if none)
    tables: dict = field(default_factory=dict)  # routing tables (np arrays)
    meta: dict = field(default_factory=dict)

    @property
    def num_channels(self) -> int:
        return int(len(self.ch_src))

    @property
    def first_eject(self) -> int:
        """First channel id of the trailing EJECT block (== #non-eject)."""
        return self.num_channels - int((self.ch_type == EJECT).sum())

    def validate(self) -> None:
        E = self.num_channels
        assert self.ch_dst.shape == (E,) and self.ch_type.shape == (E,)
        assert (self.ch_bw > 0).all() and (self.ch_lat >= 1).all()
        assert self.term_node.shape == (self.num_terminals,)
        # every terminal has an inject channel pointing at its router
        assert (self.ch_dst[self.inject_ch] == self.term_node).all()
        assert (self.ch_type[self.inject_ch] == INJECT).all()
        # eject channels are the trailing id block (engine slicing contract)
        assert (self.ch_type[self.first_eject:] == EJECT).all()


# ---------------------------------------------------------------------------
# Fault injection: degraded wafers
# ---------------------------------------------------------------------------
#
# Wafer-scale integration makes dead routers (known-good-die yield) and dead
# links (post-bond defects) the norm, not the exception.  A `FaultSet` names
# the dead channels and routers of one degraded network; the routing layer
# (`routing.route_tables`) rebuilds its fault-dependent tables on the
# surviving graph and the engine threads per-lane alive masks through the
# phase pipeline (see docs/faults.md).  A `FaultSet` alone is a COLD fault
# population (broken before cycle 0); a `FaultSchedule` sequences fault
# epochs over time — links dying mid-run while traffic is in flight — and
# is validated per epoch so the surviving network stays routable at every
# stage.

@dataclass(frozen=True)
class FaultSet:
    """Dead channels and dead routers of one degraded network.

    `dead_ch` holds explicitly failed channel ids; `dead_routers` holds
    failed router node ids.  A dead router implicitly kills every channel
    incident to it (mesh/local/global in and out, plus the inject/eject
    links of its terminals) — `ch_alive` folds both in.
    """

    dead_ch: tuple = ()
    dead_routers: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "dead_ch",
                           tuple(sorted(set(int(c) for c in self.dead_ch))))
        object.__setattr__(
            self, "dead_routers",
            tuple(sorted(set(int(r) for r in self.dead_routers))))

    @classmethod
    def empty(cls) -> "FaultSet":
        return cls()

    @property
    def is_empty(self) -> bool:
        return not self.dead_ch and not self.dead_routers

    def union(self, other: "FaultSet") -> "FaultSet":
        return FaultSet(self.dead_ch + other.dead_ch,
                        self.dead_routers + other.dead_routers)

    def node_alive(self, net: Network) -> np.ndarray:
        """Bool [V]: router survives."""
        alive = np.ones(net.num_nodes, dtype=bool)
        if self.dead_routers:
            alive[list(self.dead_routers)] = False
        return alive

    def ch_alive(self, net: Network) -> np.ndarray:
        """Bool [E]: channel survives (explicit death + incident router
        death; a terminal's inject channel dies with its router because its
        `ch_dst` is the router, its eject because its `ch_src` is)."""
        alive = np.ones(net.num_channels, dtype=bool)
        if self.dead_ch:
            alive[list(self.dead_ch)] = False
        if self.dead_routers:
            dr = np.asarray(self.dead_routers)
            alive &= ~np.isin(net.ch_src, dr)
            alive &= ~np.isin(net.ch_dst, dr)
        return alive

    def term_alive(self, net: Network) -> np.ndarray:
        """Bool [T]: terminal can inject AND eject (its router, injection
        channel, and ejection channel all survive).  A terminal with a
        dead eject channel must count as dead in both directions —
        otherwise it stays a legal destination whose packets can never
        drain and head-of-line-block the router."""
        ch_alive = self.ch_alive(net)
        return (self.node_alive(net)[net.term_node]
                & ch_alive[net.inject_ch]
                & ch_alive[term_eject_channel(net)])

    def frac_links_failed(self, net: Network) -> float:
        """Fraction of fabric links (mesh/local/global) that are dead."""
        fabric = net.ch_type <= GLOBAL
        return float((~self.ch_alive(net))[fabric].sum() / fabric.sum())


@dataclass(frozen=True)
class FaultSchedule:
    """Time-varying fault state: an ordered list of `(cycle, FaultSet)`
    epochs.  Epoch i's fault set is the FULL fault state in effect from
    `epochs[i][0]` until the next epoch's onset cycle (not a delta), so
    the lifecycle history is explicit: an epoch whose population GROWS
    is wear-out (links dying mid-run), one whose population SHRINKS is a
    repair (links/routers coming back — wafer rework, lane re-bonding, a
    rebooted router).  Both directions rebuild the per-epoch routing
    tables on that epoch's surviving subgraph (`stack_epoch_tables`), and
    both are certified per epoch by `validate`/the CDG spec pass; repair
    transitions additionally get an up*/down* phase-restart safety proof
    (`routing.verify.assert_schedule_deadlock_free`).

    The first epoch must start at cycle 0 (a pristine network is the
    single epoch `(0, FaultSet())`; a cold fault set is `cold(faults)`).
    Hashable and equality-comparable like `FaultSet`, so batched sweeps
    can memoize per-schedule lane tables.
    """

    epochs: tuple = ((0, FaultSet()),)

    def __post_init__(self):
        eps = []
        for c, f in self.epochs:
            if isinstance(f, (list, tuple)):
                f = FaultSet(*f)
            if not isinstance(f, FaultSet):
                raise ValueError(f"epoch fault entry {f!r} is not a FaultSet")
            eps.append((int(c), f))
        if not eps:
            raise ValueError("a FaultSchedule needs >= 1 epoch")
        if eps[0][0] != 0:
            raise ValueError(
                f"the first epoch must start at cycle 0, got {eps[0][0]}")
        cycles = [c for c, _ in eps]
        if any(b <= a for a, b in zip(cycles, cycles[1:])):
            raise ValueError(
                f"epoch onset cycles must be strictly increasing: {cycles}")
        object.__setattr__(self, "epochs", tuple(eps))

    @classmethod
    def cold(cls, faults: "FaultSet | None" = None) -> "FaultSchedule":
        """The single-epoch schedule equivalent to a cold fault set."""
        return cls(((0, faults or FaultSet()),))

    @property
    def num_epochs(self) -> int:
        return len(self.epochs)

    @property
    def final(self) -> FaultSet:
        """The fault state of the last epoch (the most degraded network —
        throughput divisors and failed-link fractions report this one)."""
        return self.epochs[-1][1]

    @property
    def is_static(self) -> bool:
        """True when every epoch carries the same fault set (the schedule
        is equivalent to a cold `FaultSet` — the parity baseline)."""
        return all(f == self.epochs[0][1] for _, f in self.epochs)

    @property
    def is_empty(self) -> bool:
        return all(f.is_empty for _, f in self.epochs)

    @property
    def has_repair(self) -> bool:
        """True when some epoch transition removes a fault (a dead channel
        or router comes back).  A transition may grow and shrink at once
        (one link repaired while another dies); any removal counts."""
        for (_, a), (_, b) in zip(self.epochs, self.epochs[1:]):
            if not (set(a.dead_ch) <= set(b.dead_ch)
                    and set(a.dead_routers) <= set(b.dead_routers)):
                return True
        return False

    @property
    def is_monotone(self) -> bool:
        """True when the fault population only ever accumulates (classic
        wear-out — every epoch's set contains its predecessor's)."""
        return not self.has_repair

    def repaired_at(self, i: int) -> FaultSet:
        """The faults epoch i REMOVED relative to epoch i-1 (the repair
        delta; empty for growth-only transitions).  i must be >= 1."""
        a, b = self.epochs[i - 1][1], self.epochs[i][1]
        return FaultSet(tuple(set(a.dead_ch) - set(b.dead_ch)),
                        tuple(set(a.dead_routers) - set(b.dead_routers)))

    def epoch_at(self, cycle: int) -> int:
        """Index of the epoch in effect at `cycle` (host-side mirror of
        the engine's traced epoch selection)."""
        idx = 0
        for i, (c, _) in enumerate(self.epochs):
            if cycle >= c:
                idx = i
        return idx

    def union_base(self, base: "FaultSet | None") -> "FaultSchedule":
        """Compose a base (cold) fault set into every epoch."""
        if base is None or base.is_empty:
            return self
        return FaultSchedule(tuple((c, f.union(base))
                                   for c, f in self.epochs))

    def validate(self, net: Network, vc_mode: str = "updown") -> list:
        """`validate_faults` per epoch — the surviving network must stay
        routable at EVERY stage of the schedule.  Returns the per-epoch
        summary dicts."""
        out = []
        for c, f in self.epochs:
            try:
                out.append(validate_faults(net, f, vc_mode)
                           if not f.is_empty
                           else dict(dead_channels=0, dead_routers=0,
                                     alive_terminals=net.num_terminals))
            except ValueError as e:
                raise ValueError(
                    f"schedule epoch at cycle {c} is unroutable: {e}"
                ) from None
        return out


def as_fault_schedule(f) -> FaultSchedule:
    """Promote None / `FaultSet` / `FaultSchedule` to a `FaultSchedule`."""
    if f is None:
        return FaultSchedule.cold()
    if isinstance(f, FaultSet):
        return FaultSchedule.cold(f)
    if isinstance(f, FaultSchedule):
        return f
    raise TypeError(f"expected FaultSet/FaultSchedule/None, got {type(f)}")


def final_faults(f) -> "FaultSet | None":
    """The steady-state fault set of None / `FaultSet` / `FaultSchedule`
    (None stays None; a schedule reports its last epoch)."""
    if f is None or isinstance(f, FaultSet):
        return f
    return f.final


def compose_faults(base, extra):
    """Compose two fault states (None / `FaultSet` / `FaultSchedule`).

    Set x set unions; if either side is a schedule the result is a
    schedule over the merged onset cycles, each epoch the union of the
    states the two sides hold at that cycle."""
    if extra is None:
        return base
    if base is None:
        return extra
    if isinstance(base, FaultSchedule) or isinstance(extra, FaultSchedule):
        bs, es = as_fault_schedule(base), as_fault_schedule(extra)
        cycles = sorted({c for c, _ in bs.epochs}
                        | {c for c, _ in es.epochs})
        return FaultSchedule(tuple(
            (c, bs.epochs[bs.epoch_at(c)][1]
                .union(es.epochs[es.epoch_at(c)][1])) for c in cycles))
    return base.union(extra)


def wg_channel_alive_frac(net: Network, faults: "FaultSet | None"
                          ) -> np.ndarray:
    """float [g]: surviving fraction of each W-group's internal
    (mesh + local) channels — the `weight` the fault-aware adaptive
    misroute stage uses to bias candidate intermediate W-groups away from
    degraded groups.  1.0 everywhere on a pristine network; the
    switch-based Dragonfly counts its intra-group local channels."""
    g = net.meta["g"]
    faults = faults or FaultSet()
    ch_alive = faults.ch_alive(net)
    intra = (net.ch_type == MESH) | (net.ch_type == LOCAL)
    if net.meta["kind"] == "switchless":
        NW = net.meta["ab"] * net.meta["nodes_per_cg"]
        grp = net.ch_src // NW
    else:
        grp = net.ch_src // net.meta["spg"]
    out = np.ones(g, dtype=np.float64)
    for w in range(g):
        sel = intra & (grp == w)
        if sel.any():
            out[w] = ch_alive[sel].sum() / sel.sum()
    return out


def glob_pair_alive(net: Network, faults: "FaultSet | None") -> np.ndarray:
    """bool [g, g]: the (w -> u) W-group pair keeps >= 1 alive wired
    global link (diagonal and unwired pairs read True — they are never a
    misroute hop).  Masks the adaptive misroute candidate set."""
    g = net.meta["g"]
    faults = faults or FaultSet()
    if g <= 1:
        return np.ones((g, g), dtype=bool)
    ch_alive = faults.ch_alive(net)
    wired = _wired_global_links(net)
    any_wired = (wired >= 0).any(-1)
    any_alive = ((wired >= 0) & ch_alive[np.maximum(wired, 0)]).any(-1)
    return ~any_wired | any_alive


def term_eject_channel(net: Network) -> np.ndarray:
    """int [T]: ejection channel id of each terminal (both builders wire
    eject channel of terminal t with ch_dst == V + t).  Cached on
    `net.tables` — it depends only on the network."""
    cached = net.tables.get("_term_eject")
    if cached is None:
        te = np.full(net.num_terminals, -1, dtype=np.int64)
        ejs = np.where(net.ch_type == EJECT)[0]
        te[net.ch_dst[ejs] - net.num_nodes] = ejs
        assert (te >= 0).all()
        cached = net.tables["_term_eject"] = te
    return cached


def reverse_fabric_channel(net: Network) -> np.ndarray:
    """int [E]: id of the opposite-direction mesh/local channel (-1 for
    global/inject/eject or unpaired).  A physical wafer defect kills the
    whole link bundle, i.e. both directions — samplers and validation use
    this pairing to keep mesh/local faults symmetric.  Cached on
    `net.tables` (the greedy samplers validate per candidate)."""
    cached = net.tables.get("_rev_fabric")
    if cached is not None:
        return cached
    rev = np.full(net.num_channels, -1, dtype=np.int64)
    pair = {}
    for e in np.where((net.ch_type == MESH) | (net.ch_type == LOCAL))[0]:
        pair[(net.ch_src[e], net.ch_dst[e], net.ch_type[e])] = e
    for (s, d, ty), e in pair.items():
        r = pair.get((d, s, ty), -1)
        rev[e] = r
    net.tables["_rev_fabric"] = rev
    return rev


def _wired_global_links(net: Network) -> np.ndarray:
    """int [g, g, npar] outgoing global channel id per (wg, peer, parallel
    index), -1 where unwired.  Works for both network kinds; cached on
    `net.tables`."""
    cached = net.tables.get("_wired_glob")
    if cached is not None:
        return cached
    t = net.tables
    g = net.meta["g"]
    if net.meta["kind"] == "switchless":
        ab = net.meta["ab"]
        cg = t["glob_route_cg"]                      # [g, g, npar]
        port = t["glob_route_port"]
        npar = cg.shape[-1]
        out = np.full((g, g, npar), -1, dtype=np.int64)
        for w in range(g):
            for u in range(g):
                if u == w:
                    continue
                for r in range(npar):
                    if cg[w, u, r] < 0:
                        continue
                    ch = t["ext_out"][w * ab + cg[w, u, r], port[w, u, r]]
                    out[w, u, r] = ch
    else:
        out = t["glob_out_ch"].copy()
    net.tables["_wired_glob"] = out
    return out


def validate_faults(net: Network, faults: FaultSet,
                    vc_mode: str = "updown",
                    check_wgs=None) -> dict:
    """Raise ValueError if `faults` leaves the network unroutable.

    Invariants checked:
      * at least one alive terminal;
      * every wired W-group pair keeps >= 1 alive outgoing global link
        (minimal routes re-pick among the surviving parallel links);
      * mesh/local faults are direction-symmetric (a physical defect kills
        the whole link bundle; one-directional death could leave the
        W-group weakly but not strongly connected, which up*/down* cannot
        route);
      * the surviving (mesh + local) graph of every W-group is connected
        over its alive routers (up*/down* tables are rebuilt on it);
      * `vc_mode="baseline"` (deterministic XY + fixed local ports) only
        tolerates GLOBAL-link faults — mesh/local/router faults need the
        up*/down* modes, switch-based Dragonfly networks tolerate GLOBAL
        faults only.

    `check_wgs` restricts the (Python-BFS) W-group connectivity check to
    the given W-group ids — the greedy samplers pass just the W-group a
    candidate touches, which keeps sampling linear instead of quadratic
    in the fault count.  `None` checks every W-group.

    Returns a small summary dict (counts) on success.
    """
    ch_alive = faults.ch_alive(net)
    term_alive = faults.term_alive(net)
    if not term_alive.any():
        raise ValueError("faults kill every terminal")
    dead = ~ch_alive
    rev = reverse_fabric_channel(net)
    paired = rev >= 0
    asym = paired & (dead != dead[np.maximum(rev, 0)])
    if asym.any():
        raise ValueError(
            f"mesh/local faults must kill both directions of a link "
            f"(channels {np.flatnonzero(asym)[:6]} died one-way)")
    kind = net.meta["kind"]
    nonglobal_dead = (dead & (net.ch_type != GLOBAL)).any() \
        or bool(faults.dead_routers)
    if kind == "dragonfly" and nonglobal_dead:
        raise ValueError(
            "switch-based Dragonfly fault model supports GLOBAL-link "
            "faults only (local links have no alternative path)")
    if kind == "switchless" and vc_mode == "baseline" and nonglobal_dead:
        raise ValueError(
            "vc_mode='baseline' routes deterministically inside W-groups "
            "and only tolerates GLOBAL-link faults; use the up*/down* "
            "modes for mesh/local/router faults")
    # every wired W-group pair keeps an alive outgoing global link
    g = net.meta["g"]
    if g > 1:
        wired = _wired_global_links(net)
        alive_cnt = ((wired >= 0) & ch_alive[np.maximum(wired, 0)]).sum(-1)
        wired_cnt = (wired >= 0).sum(-1)
        bad = (wired_cnt > 0) & (alive_cnt == 0)
        if bad.any():
            w, u = np.argwhere(bad)[0]
            raise ValueError(
                f"faults kill every global link W-group {w} -> {u}")
    # surviving W-group graphs stay connected over alive routers
    if kind == "switchless":
        for wg, comp in _wgroup_components(net, faults,
                                           wgs=check_wgs).items():
            if comp > 1:
                raise ValueError(
                    f"faults disconnect the surviving graph of W-group "
                    f"{wg} ({comp} components)")
    return dict(dead_channels=int(dead.sum()),
                dead_routers=len(faults.dead_routers),
                alive_terminals=int(term_alive.sum()))


def wgroup_adjacency(net: Network, faults: FaultSet | None = None,
                     wgs=None):
    """Per-W-group alive adjacency over wg-local router ids.

    Returns (adj, alive) where adj[wg] maps u -> list of (v, weight) over
    surviving mesh/local channels and alive[wg] is the bool router-alive
    mask, both in wg-local ids (u = node % (ab * nodes_per_cg)).  With
    `wgs`, only those W-groups get adjacency lists (the rest stay empty)
    — the incremental-validation fast path."""
    assert net.meta["kind"] == "switchless"
    faults = faults or FaultSet()
    ab, npc = net.meta["ab"], net.meta["nodes_per_cg"]
    NW = ab * npc
    g = net.meta["g"]
    ch_alive = faults.ch_alive(net)
    node_alive = faults.node_alive(net)
    intra = (net.ch_type == MESH) | (net.ch_type == LOCAL)
    keep = intra & ch_alive
    if wgs is not None:
        keep &= np.isin(net.ch_src // NW, np.asarray(list(wgs)))
    eids = np.where(keep)[0]
    src, dst = net.ch_src[eids], net.ch_dst[eids]
    wgt = np.where(net.ch_type[eids] == MESH, 1, 4)
    adj = [[[] for _ in range(NW)] for _ in range(g)]
    for s, d, w in zip(src, dst, wgt):
        if node_alive[s] and node_alive[d]:
            adj[s // NW][s % NW].append((d % NW, int(w)))
    alive = node_alive.reshape(g, NW)
    return adj, alive


def _wgroup_components(net: Network, faults: FaultSet,
                       wgs=None) -> dict:
    """Connected-component count of the surviving graph, per W-group
    (all of them, or just `wgs`)."""
    wg_list = list(range(net.meta["g"])) if wgs is None else sorted(wgs)
    adj, alive = wgroup_adjacency(net, faults, wgs=wg_list)
    out = {}
    for wg in wg_list:
        al = alive[wg]
        seen = ~al.copy()
        comps = 0
        for root in np.where(al)[0]:
            if seen[root]:
                continue
            comps += 1
            stack = [root]
            seen[root] = True
            while stack:
                u = stack.pop()
                for v, _ in adj[wg][u]:
                    if not seen[v]:
                        seen[v] = True
                        stack.append(v)
        out[wg] = comps
    return out


def _greedy_valid(net: Network, candidates, vc_mode: str,
                  routers: bool = False,
                  base: FaultSet | None = None) -> FaultSet:
    """Accumulate faults one candidate at a time on top of `base`,
    skipping any that would break `validate_faults` — degraded networks
    stay routable by construction.  A non-router candidate may be a
    channel id or a tuple of channel ids that die together (both
    directions of a link).

    Each step validates incrementally: the per-W-group connectivity BFS
    only covers the W-group(s) the candidate touches (the vectorized
    global/terminal/symmetry checks always run), so sampling stays
    ~linear in the fault count instead of quadratic."""
    cur = base or FaultSet()
    if base is not None and not base.is_empty:
        validate_faults(net, base, vc_mode)   # base checked in full once
    switchless = net.meta["kind"] == "switchless"
    NW = (net.meta["ab"] * net.meta["nodes_per_cg"]) if switchless else 1
    for c in candidates:
        if routers:
            trial = FaultSet(cur.dead_ch, cur.dead_routers + (int(c),))
            touched = {int(c) // NW} if switchless else None
        else:
            chs = tuple(int(x) for x in np.atleast_1d(c) if int(x) >= 0)
            trial = FaultSet(cur.dead_ch + chs, cur.dead_routers)
            touched = {int(net.ch_src[ch]) // NW for ch in chs
                       if net.ch_type[ch] in (MESH, LOCAL)} \
                if switchless else None
        try:
            validate_faults(net, trial, vc_mode, check_wgs=touched)
        except ValueError:
            continue
        cur = trial
    return cur


def sample_link_faults(net: Network, frac: float,
                       rng: np.random.Generator,
                       types=(MESH, LOCAL, GLOBAL),
                       vc_mode: str = "updown",
                       base: FaultSet | None = None) -> FaultSet:
    """Kill ~`frac` of the fabric links of the given types, uniformly at
    random, skipping kills that would disconnect the surviving network.

    Mesh/local links die as whole bundles (both directions at once, see
    `reverse_fabric_channel`); global links die per direction.  `base`
    composes on top of existing faults (the result includes them and
    stays valid as a whole)."""
    rev = reverse_fabric_channel(net)
    cand = np.where(np.isin(net.ch_type, np.asarray(types))
                    & ((rev < 0) | (np.arange(net.num_channels) < rev)))[0]
    n = int(round(frac * len(cand)))
    if n == 0:
        return base or FaultSet()
    picks = rng.choice(cand, size=min(n, len(cand)), replace=False)
    return _greedy_valid(net, [(c, rev[c]) for c in picks], vc_mode,
                         base=base)


def sample_router_faults(net: Network, num: int,
                         rng: np.random.Generator,
                         vc_mode: str = "updown",
                         base: FaultSet | None = None) -> FaultSet:
    """Kill up to `num` whole routers (known-good-die yield loss), skipping
    kills that would disconnect the surviving network."""
    picks = rng.choice(net.num_nodes, size=min(num, net.num_nodes),
                      replace=False)
    return _greedy_valid(net, picks, vc_mode, routers=True, base=base)


def sample_cluster_faults(net: Network, rng: np.random.Generator,
                          num_clusters: int = 1, radius: int = 1,
                          vc_mode: str = "updown",
                          base: FaultSet | None = None) -> FaultSet:
    """Clustered defect regions: kill the routers within Chebyshev
    `radius` of a random centre router of a random C-group (defects on a
    wafer are spatially correlated, not iid)."""
    assert net.meta["kind"] == "switchless"
    R = net.meta["R"]
    npc = net.meta["nodes_per_cg"]
    num_cg = net.meta["num_cgroups"]
    picks = []
    for _ in range(num_clusters):
        cgg = int(rng.integers(0, num_cg))
        cx, cy = int(rng.integers(0, R)), int(rng.integers(0, R))
        for y in range(max(0, cy - radius), min(R, cy + radius + 1)):
            for x in range(max(0, cx - radius), min(R, cx + radius + 1)):
                picks.append(cgg * npc + y * R + x)
    order = rng.permutation(len(picks))
    return _greedy_valid(net, [picks[i] for i in order], vc_mode,
                         routers=True, base=base)


# ---------------------------------------------------------------------------
# Switch-less Dragonfly on wafers
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SwitchlessParams:
    """Paper notation (Sec. III).

    a   C-groups per wafer
    b   wafers per W-group
    m   chiplets per C-group edge (C-group is m x m chiplets)
    n   interconnection interfaces per chiplet (n/4 per edge)
    noc on-chiplet network edge size (eval uses 2 -> 2x2 routers per chiplet)
    g   number of W-groups; None -> maximum ab*h+1
    cg_bw_mult  intra-C-group (on-wafer) bandwidth multiplier ("2B/4B" runs)
    """

    a: int
    b: int
    m: int
    n: int
    noc: int = 2
    g: int | None = None
    cg_bw_mult: int = 1
    lr_latency: int = 8
    sr_latency: int = 1
    # routers per chip override: by default a chip is a noc x noc router tile;
    # set e.g. 2 to model chips owning 2 routers (radix-32 equivalence where
    # the C-group hosts 8 chips on a 4x4 router grid).
    chip_routers: int | None = None

    @property
    def k(self) -> int:
        """External ports of a C-group (Sec. III-A2: k = n*m)."""
        return self.n * self.m

    @property
    def ab(self) -> int:
        return self.a * self.b

    @property
    def h(self) -> int:
        """Global ports per C-group: h = k - ab + 1 (Sec. III-A4)."""
        return self.k - self.ab + 1

    @property
    def g_max(self) -> int:
        """Max W-groups: g = ab*h + 1 (Sec. III-A4)."""
        return self.ab * self.h + 1

    @property
    def num_wgroups(self) -> int:
        g = self.g_max if self.g is None else self.g
        if not (1 <= g <= self.g_max):
            raise ValueError(f"g={g} outside [1,{self.g_max}]")
        return g

    @property
    def R(self) -> int:
        """Router-grid edge size of a C-group."""
        return self.m * self.noc

    @property
    def routers_per_chip(self) -> int:
        if self.chip_routers is not None:
            return self.chip_routers
        return self.noc * self.noc

    @property
    def chips_per_cgroup(self) -> int:
        rr = self.R * self.R
        assert rr % self.routers_per_chip == 0
        return rr // self.routers_per_chip

    @property
    def num_chips(self) -> int:
        return self.chips_per_cgroup * self.ab * self.num_wgroups

    @property
    def N_eq1(self) -> int:
        """Eq. (1): N = a*b*m^2 * g with g at maximum."""
        return self.ab * self.m * self.m * self.g_max


def _perimeter_walk(R: int) -> list[tuple[int, int]]:
    """Clockwise walk of the R x R grid perimeter starting at (0, 0).

    Returns 4*(R-1) (x, y) positions (x = column, y = row, row 0 at top).
    This is the polar-system labeling of Fig. 8(c): ports are ordered along
    this walk, which makes port-to-port ring routing monotone in the label.
    """
    if R == 1:
        return [(0, 0)]
    walk = []
    for x in range(R - 1):
        walk.append((x, 0))          # top edge, left->right
    for y in range(R - 1):
        walk.append((R - 1, y))      # right edge, top->bottom
    for x in range(R - 1, 0, -1):
        walk.append((x, R - 1))      # bottom edge, right->left
    for y in range(R - 1, 0, -1):
        walk.append((0, y))          # left edge, bottom->top
    return walk


def build_switchless(p: SwitchlessParams, name: str = "switchless") -> Network:
    """Build the switch-less Dragonfly router/channel graph + routing tables."""
    R = p.R
    ab, k, g = p.ab, p.k, p.num_wgroups
    if p.h < 1:
        raise ValueError(f"h={p.h} < 1: k={p.k} too small for ab={ab}")
    n_local = ab - 1
    perim = _perimeter_walk(R)
    P = len(perim)
    # Distribute the k ports evenly along the perimeter walk (polar labels).
    # k may exceed P (several ports per perimeter router, cf. Fig. 9 where a
    # chiplet edge carries multiple channels); floor keeps labels monotone
    # along the walk so the polar up*/down* ordering is preserved.
    port_pos = np.floor(np.arange(k) * P / k).astype(np.int64)
    port_xy = np.array([perim[i] for i in port_pos], dtype=np.int64)  # [k,2]

    num_cg = ab * g
    nodes_per_cg = R * R
    V = num_cg * nodes_per_cg
    T = V  # one terminal per router (chiplet core)

    def node_id(wg: int, cg: int, x: int, y: int) -> int:
        return ((wg * ab + cg) * nodes_per_cg) + y * R + x

    # --- node / terminal metadata -------------------------------------
    idx = np.arange(V)
    node_cg_global = idx // nodes_per_cg
    node_wg = node_cg_global // ab
    node_cg = node_cg_global % ab
    node_local = idx % nodes_per_cg
    node_x = node_local % R
    node_y = node_local // R
    if p.chip_routers is None:
        # chip id: chiplets are noc x noc router tiles
        chip_x = node_x // p.noc
        chip_y = node_y // p.noc
        node_chip = node_cg_global * p.chips_per_cgroup + chip_y * p.m + chip_x
    else:
        node_chip = node_cg_global * p.chips_per_cgroup + \
            node_local // p.chip_routers
    term_node = idx.copy()
    term_chip = node_chip.copy()

    # --- channels ------------------------------------------------------
    src, dst, bw, lat, typ = [], [], [], [], []

    def add(s, d, b, l, t):
        src.append(s); dst.append(d); bw.append(b); lat.append(l); typ.append(t)
        return len(src) - 1

    # mesh channels, per C-group: node -> 4 neighbours (N,E,S,W order)
    DIRS = ((0, -1), (1, 0), (0, 1), (-1, 0))  # N, E, S, W in (dx, dy)
    node_mesh_ch = np.full((V, 4), -1, dtype=np.int64)
    for cgg in range(num_cg):
        wg, cg = divmod(cgg, ab)
        for y in range(R):
            for x in range(R):
                s = node_id(wg, cg, x, y)
                for di, (dx, dy) in enumerate(DIRS):
                    nx, ny = x + dx, y + dy
                    if 0 <= nx < R and 0 <= ny < R:
                        c = add(s, node_id(wg, cg, nx, ny),
                                p.cg_bw_mult, p.sr_latency, MESH)
                        node_mesh_ch[s, di] = c

    # inject channels (ejects are added LAST: trailing-block contract)
    inject_ch = np.zeros(T, dtype=np.int64)
    for t in range(T):
        inject_ch[t] = add(V + t, term_node[t], 1, 1, INJECT)  # src id unused

    # port labeling and the local/global split (Fig. 6):
    # ports 0..n_local-1 are LOCAL (to the other ab-1 C-groups of the W-group),
    # ports n_local..k-1 are GLOBAL.  Property 2 ordering: within the polar
    # walk the local ports to lower C-groups come first, then globals, then
    # local ports to higher C-groups.  We realize it by mapping: local port j
    # of C-group c connects to C-group (c + 1 + j) mod ab ... see below; and
    # placing globals in the middle of the label range.
    # Concretely we order port labels:
    #   labels [0, cg)             -> local ports to C-groups 0..cg-1 (down)
    #   labels [cg, cg + h)        -> global ports
    #   labels [cg + h, k)         -> local ports to C-groups cg+1..ab-1 (up)
    # which satisfies Property 2 exactly.
    local_port = np.full((ab, ab), -1, dtype=np.int64)   # [cg, peer_cg] -> port
    global_ports = np.zeros((ab, p.h), dtype=np.int64)   # [cg, j] -> port label
    for cg in range(ab):
        for peer in range(ab):
            if peer < cg:
                local_port[cg, peer] = peer
            elif peer > cg:
                local_port[cg, peer] = p.h + peer - 1
        for j in range(p.h):
            global_ports[cg, j] = cg + j  # labels cg..cg+h-1 are global
    # NOTE: with this scheme label ranges depend on cg; all labels < k.

    # external channel endpoints: ext_out[cgg, port] = channel id
    ext_out = np.full((num_cg, k), -1, dtype=np.int64)

    # local links: within each W-group, C-groups fully connected
    for wg in range(g):
        for c1 in range(ab):
            for c2 in range(ab):
                if c1 == c2:
                    continue
                p1 = local_port[c1, c2]
                s = node_id(wg, c1, *port_xy[p1])
                d_port = local_port[c2, c1]
                d = node_id(wg, c2, *port_xy[d_port])
                ch = add(s, d, 1, p.lr_latency, LOCAL)
                ext_out[wg * ab + c1, p1] = ch

    # global links: W-groups fully connected (Sec. III-A4).  Port q of
    # W-group w (q = cg*h + j in [0, ab*h)) connects toward W-group
    # (w + q + 1) mod g.  When g < g_max the surplus ports wrap around and
    # give PARALLEL links per W-group pair; all of them are wired (routing
    # spreads flows across them by destination hash).
    npar = max(1, (ab * p.h) // max(g - 1, 1)) if g > 1 else 1
    glob_route_cg = np.full((g, g, npar), -1, dtype=np.int64)
    glob_route_port = np.full((g, g, npar), -1, dtype=np.int64)
    glob_npar = np.ones((g, g), dtype=np.int64)
    if g > 1:
        for wg in range(g):
            cnt = np.zeros(g, dtype=np.int64)
            for q in range(ab * p.h):
                peer = (wg + q + 1) % g
                if peer == wg or cnt[peer] >= npar:
                    continue
                cg, j = divmod(q, p.h)
                glob_route_cg[wg, peer, cnt[peer]] = cg
                glob_route_port[wg, peer, cnt[peer]] = global_ports[cg, j]
                cnt[peer] += 1
            glob_npar[wg] = np.maximum(cnt, 1)
        # parallel index r of (wg, peer) pairs with r-th link of (peer, wg)
        for wg in range(g):
            for peer in range(g):
                if peer == wg:
                    continue
                for r in range(npar):
                    cg = glob_route_cg[wg, peer, r]
                    if cg < 0 or glob_route_cg[peer, wg, r] < 0:
                        continue
                    port = glob_route_port[wg, peer, r]
                    s = node_id(wg, cg, *port_xy[port])
                    pcg = glob_route_cg[peer, wg, r]
                    pport = glob_route_port[peer, wg, r]
                    d = node_id(peer, pcg, *port_xy[pport])
                    ch = add(s, d, 1, p.lr_latency, GLOBAL)
                    ext_out[wg * ab + cg, port] = ch
        # routable parallel count = links wired in BOTH directions
        glob_npar = np.minimum(glob_npar, glob_npar.T)
        np.fill_diagonal(glob_npar, 1)

    # eject channels last: the engine slices requesters to [:first_eject]
    eject_ch = np.full(V, -1, dtype=np.int64)
    for t in range(T):
        eject_ch[t] = add(term_node[t], V + t, 1, 1, EJECT)

    # --- routing tables --------------------------------------------------
    # perimeter position of each node (-1 if interior) for ring routing
    perim_pos = np.full(V, -1, dtype=np.int64)
    pos_of_xy = {xy: i for i, xy in enumerate(perim)}
    for v in range(V):
        xy = (int(node_x[v]), int(node_y[v]))
        if xy in pos_of_xy:
            perim_pos[v] = pos_of_xy[xy]
    # ring next/prev direction index (into DIRS) for each perimeter position
    ring_next_dir = np.zeros(P, dtype=np.int64)
    ring_prev_dir = np.zeros(P, dtype=np.int64)
    for i in range(P):
        x0, y0 = perim[i]
        x1, y1 = perim[(i + 1) % P]
        ring_next_dir[i] = DIRS.index((int(np.sign(x1 - x0)), int(np.sign(y1 - y0))))
        ring_prev_dir[(i + 1) % P] = DIRS.index((int(np.sign(x0 - x1)), int(np.sign(y0 - y1))))
    # port -> (node-local x, y), port -> perimeter pos
    port_node_local = port_xy[:, 1] * R + port_xy[:, 0]
    port_perim_pos = port_pos.copy()

    # snake (boustrophedon) order of chips for ring embeddings: consecutive
    # chips in the ring are physically adjacent on the wafer
    if p.chip_routers is None:
        cm = p.m  # chip grid is m x m
        snake_local = []
        for cy in range(cm):
            xs = range(cm) if cy % 2 == 0 else range(cm - 1, -1, -1)
            snake_local.extend(cy * cm + cx for cx in xs)
    else:
        snake_local = list(range(p.chips_per_cgroup))
    cpc = p.chips_per_cgroup
    chip_ring_order = np.concatenate([
        cgg * cpc + np.asarray(snake_local) for cgg in range(num_cg)])

    tables = dict(
        node_wg=node_wg, node_cg=node_cg, node_cg_global=node_cg_global,
        node_x=node_x, node_y=node_y,
        node_mesh_ch=node_mesh_ch, eject_ch=eject_ch,
        ext_out=ext_out, local_port=local_port,
        glob_route_cg=glob_route_cg, glob_route_port=glob_route_port,
        glob_npar=glob_npar,
        port_node_local=port_node_local, port_perim_pos=port_perim_pos,
        perim_pos=perim_pos, ring_next_dir=ring_next_dir,
        ring_prev_dir=ring_prev_dir,
        term_node=term_node,
        chip_ring_order=chip_ring_order,
        wg_term_base=np.arange(g) * ab * nodes_per_cg,
    )
    meta = dict(kind="switchless", params=dataclasses.asdict(p), R=R, ab=ab,
                k=k, h=p.h, g=g, nodes_per_cg=nodes_per_cg,
                terms_per_wg=ab * nodes_per_cg,
                terms_per_chip=p.routers_per_chip,
                num_cgroups=num_cg)

    net = Network(
        name=name, num_nodes=V, num_terminals=T, num_chips=int(p.num_chips),
        term_node=term_node, term_chip=term_chip,
        ch_src=np.array(src), ch_dst=np.array(dst),
        ch_bw=np.array(bw, dtype=np.int64), ch_lat=np.array(lat, dtype=np.int64),
        ch_type=np.array(typ, dtype=np.int64),
        inject_ch=inject_ch, eject_ch=eject_ch, tables=tables, meta=meta)
    net.validate()
    return net


# ---------------------------------------------------------------------------
# Traditional switch-based Dragonfly (baseline, Kim et al. 2008)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SwitchDragonflyParams:
    """Standard Dragonfly: radix = t + l + gl per switch.

    t terminals/switch, l local ports (group has l+1 switches), gl global
    ports/switch.  Groups: g <= (l+1)*gl + 1.
    """

    t: int
    l: int
    gl: int
    g: int | None = None
    lr_latency: int = 8

    @property
    def radix(self) -> int:
        return self.t + self.l + self.gl

    @property
    def switches_per_group(self) -> int:
        return self.l + 1

    @property
    def g_max(self) -> int:
        return self.switches_per_group * self.gl + 1

    @property
    def num_groups(self) -> int:
        g = self.g_max if self.g is None else self.g
        if not (1 <= g <= self.g_max):
            raise ValueError(f"g={g} outside [1,{self.g_max}]")
        return g

    @property
    def num_chips(self) -> int:
        return self.t * self.switches_per_group * self.num_groups


def build_switch_dragonfly(p: SwitchDragonflyParams,
                           name: str = "dragonfly") -> Network:
    """Ideal-router switch-based Dragonfly (paper's baseline)."""
    g = p.num_groups
    spg = p.switches_per_group
    V = g * spg                      # switch nodes
    T = V * p.t                      # terminals

    term_node = np.repeat(np.arange(V), p.t)
    term_chip = np.arange(T)         # every terminal is a chip

    src, dst, bw, lat, typ = [], [], [], [], []

    def add(s, d, b, l, t):
        src.append(s); dst.append(d); bw.append(b); lat.append(l); typ.append(t)
        return len(src) - 1

    inject_ch = np.zeros(T, dtype=np.int64)
    for t_ in range(T):
        inject_ch[t_] = add(V + t_, term_node[t_], 1, 1, INJECT)

    # local links: full mesh within each group
    local_ch = np.full((V, spg), -1, dtype=np.int64)  # [switch, peer_idx]
    for grp in range(g):
        base = grp * spg
        for i in range(spg):
            for j in range(spg):
                if i == j:
                    continue
                local_ch[base + i, j] = add(base + i, base + j, 1,
                                            p.lr_latency, LOCAL)

    # global links: group w port q -> group (w + q + 1) mod g; port q lives
    # on switch q // gl.  Surplus ports when g < g_max wrap into parallel
    # links per group pair, all wired.
    npar = max(1, (spg * p.gl) // max(g - 1, 1)) if g > 1 else 1
    glob_route_sw = np.full((g, g, npar), -1, dtype=np.int64)
    glob_out_ch = np.full((g, g, npar), -1, dtype=np.int64)
    glob_npar = np.ones((g, g), dtype=np.int64)
    if g > 1:
        for grp in range(g):
            cnt = np.zeros(g, dtype=np.int64)
            for q in range(spg * p.gl):
                peer = (grp + q + 1) % g
                if peer == grp or cnt[peer] >= npar:
                    continue
                glob_route_sw[grp, peer, cnt[peer]] = grp * spg + q // p.gl
                cnt[peer] += 1
            glob_npar[grp] = np.maximum(cnt, 1)
        for grp in range(g):
            for peer in range(g):
                if peer == grp:
                    continue
                for r in range(npar):
                    sw = glob_route_sw[grp, peer, r]
                    psw = glob_route_sw[peer, grp, r]
                    if sw < 0 or psw < 0:
                        continue
                    glob_out_ch[grp, peer, r] = add(sw, psw, 1,
                                                    p.lr_latency, GLOBAL)
        glob_npar = np.minimum(glob_npar, glob_npar.T)
        np.fill_diagonal(glob_npar, 1)

    # eject channels last (trailing-block contract, cf. build_switchless)
    eject_sw_term = np.full((V, p.t), -1, dtype=np.int64)  # per-terminal eject
    for t_ in range(T):
        sw = term_node[t_]
        eject_sw_term[sw, t_ % p.t] = add(sw, V + t_, 1, 1, EJECT)

    eject_ch = np.full(V, -1, dtype=np.int64)  # first eject per switch (unused)
    tables = dict(
        node_grp=np.arange(V) // spg, node_idx=np.arange(V) % spg,
        local_ch=local_ch, glob_route_sw=glob_route_sw,
        glob_out_ch=glob_out_ch, glob_npar=glob_npar,
        eject_sw_term=eject_sw_term,
        term_node=term_node, term_slot=np.arange(T) % p.t,
        chip_ring_order=np.arange(T),
        grp_term_base=np.arange(g) * spg * p.t,
    )
    meta = dict(kind="dragonfly", params=dataclasses.asdict(p), g=g, spg=spg,
                terms_per_grp=spg * p.t, terms_per_chip=1)
    net = Network(
        name=name, num_nodes=V, num_terminals=T, num_chips=T,
        term_node=term_node, term_chip=term_chip,
        ch_src=np.array(src), ch_dst=np.array(dst),
        ch_bw=np.array(bw, dtype=np.int64), ch_lat=np.array(lat, dtype=np.int64),
        ch_type=np.array(typ, dtype=np.int64),
        inject_ch=inject_ch, eject_ch=eject_ch, tables=tables, meta=meta)
    net.validate()
    return net


# --- canonical evaluation configurations (Sec. V-A4) -----------------------

def paper_radix16_switchless(g: int | None = None, cg_bw_mult: int = 1,
                             noc: int = 2) -> SwitchlessParams:
    """2x2 chiplets with 2x2 on-chiplet NoC; 12 external ports (7 local +
    5 global); 8 C-groups per W-group; 41 W-groups, 1312 chips."""
    return SwitchlessParams(a=2, b=4, m=2, n=6, noc=noc, g=g,
                            cg_bw_mult=cg_bw_mult)


def paper_radix16_dragonfly(g: int | None = None) -> SwitchDragonflyParams:
    """Radix-16 switch split 4:7:5 -> (41 groups, 1312 chips)."""
    return SwitchDragonflyParams(t=4, l=7, gl=5, g=g)


def paper_radix32_switchless(g: int | None = None, cg_bw_mult: int = 1
                             ) -> SwitchlessParams:
    """Radix-32-equivalent: 24 external ports (15 local + 9 global),
    16 C-groups per W-group, 8 chips per C-group -> 145 groups, 18560 chips.

    ab=16, k=nm=24 -> h=9, g_max=145.  The 4x4 router grid (m=2 chiplets with
    2x2 NoCs) hosts 8 chips of 2 routers each (chip_routers=2), matching the
    paper's 8 terminals per radix-32 switch: N = 8*16*145 = 18560.
    """
    return SwitchlessParams(a=4, b=4, m=2, n=12, noc=2, g=g,
                            cg_bw_mult=cg_bw_mult, chip_routers=2)


def paper_radix32_dragonfly(g: int | None = None) -> SwitchDragonflyParams:
    """Radix-32 switch split 8:15:9 -> (145 groups, 18560 chips)."""
    return SwitchDragonflyParams(t=8, l=15, gl=9, g=g)


def paper_table3_switchless() -> SwitchlessParams:
    """Sec. III-C case study: n=12, m=4, a=4, b=8 -> N=279040."""
    return SwitchlessParams(a=4, b=8, m=4, n=12, noc=1)
