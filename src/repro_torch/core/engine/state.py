"""Simulation state (dataclasses of tensors) and static model constants.

Port of `repro.core.engine.state`.  `SimState` is the carry of the cycle
loop.  Every tensor has a leading lane dimension ``B`` (the reference's
`vmap` axis over (rate x seed x fault) lanes); the phase functions never
mix lanes.

`build_consts` packages the static (per-network, per-config) tensors the
phases close over; `build_lane` the per-lane fault data (`fl`), which the
engine hands to the step lane-stacked (`stack_lanes`) or shared
(`routing.share_lanes`).

Device rule: the public entry points run on CUDA unless the caller passes
``device="cpu"``; with no CUDA device they raise (`resolve_device`,
from `repro_torch.device`).
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ... import env_int
from ...device import resolve_device  # noqa: F401  (re-exported)
from ...tensors import as_tensor
from ..topology import (NUM_CH_TYPES, FaultSchedule, FaultSet, Network,
                        glob_pair_alive, wg_channel_alive_frac)
from ..routing import make_route_kernel, num_vcs, route_tables

INF32 = 2**31 - 1

# payload-field indices of the packed per-packet record in `SimState.b_pkt`
F_DEST, F_ITIME, F_MIS, F_META, F_READY = range(5)
NUM_FIELDS = 5
NUM_SRC_FIELDS = 3      # source-queue records pack (dest, itime, mis)

# the fused and compact steps extend the record with the CACHED next-hop
# route decision (output channel, requested VC class, next routing meta),
# evaluated once when the packet is pushed; warm-fault (epoch-scheduled)
# lanes route per cycle instead and leave these fields zero (see
# `fused.py`)
F_OUT, F_CLS, F_META2 = 5, 6, 7
NUM_FUSED_FIELDS = 8

# step impls whose records carry the cached-route tail
CACHED_ROUTE_IMPLS = ("fused", "compact")


def resolve_reap_age(cfg) -> int:
    """Effective router-death reaper park age for this run (cycles):
    `cfg.reap_age` when nonzero, else the process-wide REPRO_REAP_AGE
    default; 0 disables the reaper (the step then runs no reap logic)."""
    age = int(getattr(cfg, "reap_age", 0))
    return age if age > 0 else env_int("REPRO_REAP_AGE", 0)


@dataclass
class SimStats:
    """Measurement accumulators (zeroed at the end of warmup), one entry
    per lane.  See the reference `SimStats` for the semantics of the
    `stranded` gauge, the `reaped` counter and the `occ_peak` high-water
    mark (which survives the warmup reset)."""

    delivered: torch.Tensor   # [B] packets ejected
    lat_sum: torch.Tensor     # [B] float32 sum of generation->ejection cycles
    generated: torch.Tensor   # [B] packets generated (incl. dropped)
    dropped: torch.Tensor     # [B] source-queue overflow
    stranded: torch.Tensor    # [B] gauge: requests parked on the -1 channel
    reaped: torch.Tensor      # [B] packets the reaper dropped (age-based)
    occ_peak: torch.Tensor    # [B] high-water mark of live request rows
    hops: torch.Tensor        # [B, NUM_CH_TYPES] traversals by type

    def replace(self, **kw) -> "SimStats":
        return replace(self, **kw)

    @classmethod
    def zeros(cls, batch: tuple = (), device=None) -> "SimStats":
        z = lambda *s: torch.zeros(tuple(batch) + s, dtype=torch.int32,
                                   device=device)
        return cls(delivered=z(), lat_sum=torch.zeros(
                       tuple(batch), dtype=torch.float32, device=device),
                   generated=z(), dropped=z(), stranded=z(), reaped=z(),
                   occ_peak=z(), hops=z(NUM_CH_TYPES))


@dataclass
class SimState:
    """All mutable router/terminal state, over (channel E, VC NV, slot S)
    and (terminal T, source-queue slot Q); ring buffers of packets.

    `b_pkt` and `s_pkt` are updated IN PLACE by the phases (the step
    returns the same tensors); the small per-buffer counters are replaced
    each cycle.  `b_pkt` is a view that hides one spare channel row (see
    `with_sink_row`)."""

    b_pkt: torch.Tensor       # [B, E, NV, S, F], F per `make_state`
    b_head: torch.Tensor      # [B, E, NV] ring head
    b_count: torch.Tensor     # [B, E, NV] occupancy (packets)
    s_pkt: torch.Tensor       # [B, T, Q, NUM_SRC_FIELDS]
    s_head: torch.Tensor      # [B, T]
    s_count: torch.Tensor     # [B, T]
    ch_busy: torch.Tensor     # [B, E] serialization busy countdown
    stats: SimStats

    def replace(self, **kw) -> "SimState":
        return replace(self, **kw)


def make_state(net: Network, cfg, NV: int, batch: tuple = (), *,
               ch_pad: int = 0, term_pad: int = 0,
               blocks: tuple | None = None, device=None) -> SimState:
    """Fresh (empty-network) state; `batch` prepends lane axes (the step
    takes exactly one).  `b_pkt` is allocated with one spare channel row
    (index E) behind the returned view: the apply phase points the
    scatter rows of non-winners at it, the port's form of the
    reference's ``mode="drop"`` scatter.

    `ch_pad` / `term_pad` append GHOST channels/terminals (the
    channel-sharded fused step's padding, `fused.fused_pad`): they start
    empty, are dead in every alive mask and never inject, so zeros are
    already right for them.  `blocks=(Ek, Tk)` allocates only one shard's
    blocks of the two big arrays, `b_pkt [.., Ek, ...]` and
    `s_pkt [.., Tk, ...]`; the rest keeps the padded sizes.

    The record width follows `cfg.step_impl`: the fused and compact
    steps carry the cached route fields (`NUM_FUSED_FIELDS`), the oracle
    the base payload (`NUM_FIELDS`)."""
    device = resolve_device(device)
    E, T = net.num_channels + ch_pad, net.num_terminals + term_pad
    Eb, Tb = (E, T) if blocks is None else blocks
    S, Q = cfg.buf_pkts, cfg.srcq_pkts
    nf = (NUM_FUSED_FIELDS
          if getattr(cfg, "step_impl", "jnp") in CACHED_ROUTE_IMPLS
          else NUM_FIELDS)
    batch = tuple(batch)
    z = lambda *s: torch.zeros(batch + s, dtype=torch.int32, device=device)
    b_store = z(Eb + 1, NV, S, nf)
    return SimState(
        b_pkt=b_store.narrow(len(batch), 0, Eb),
        b_head=z(E, NV), b_count=z(E, NV),
        s_pkt=z(Tb, Q, NUM_SRC_FIELDS),
        s_head=z(T), s_count=z(T),
        ch_busy=z(E),
        stats=SimStats.zeros(batch, device))


def with_sink_row(b_pkt: torch.Tensor) -> torch.Tensor:
    """The ``[B, E+1, ...]`` storage behind a `make_state` ``b_pkt`` view
    ``[B, E, ...]``: the same memory plus the spare row E.  Raises when
    the tensor has no spare row behind it."""
    size = (b_pkt.shape[0], b_pkt.shape[1] + 1) + tuple(b_pkt.shape[2:])
    return b_pkt.as_strided(size, b_pkt.stride(), b_pkt.storage_offset())


def build_consts(net: Network, cfg, *, device):
    """Static (per-net, per-cfg) tensors + the route KERNEL.  The
    fault-dependent data (routing tables, alive masks) lives in the
    per-lane `fl` dict instead (`build_lane`)."""
    NV = num_vcs(net.meta["kind"], cfg.vc_mode, cfg.nonminimal) \
        * cfg.vcs_per_class
    E = net.num_channels
    T = net.num_terminals
    route_kernel = make_route_kernel(net, cfg.vc_mode, device=device)
    ser = (cfg.pkt_len + net.ch_bw - 1) // net.ch_bw  # serialization cycles
    wg_tbl = net.tables.get("node_wg", net.tables.get("node_grp"))
    # wg of the downstream node of each channel (for misroute clearing)
    ch_dst_wg = wg_tbl[np.clip(net.ch_dst, 0, net.num_nodes - 1)]
    d = lambda x: as_tensor(x, device)
    consts = dict(
        NV=NV, E=E, T=T,
        # eject channels are the trailing id block (Network.validate); they
        # never request, so the request grid covers only [:E_req]
        E_req=net.first_eject,
        ch_dst=d(net.ch_dst),
        ch_ser=d(ser),
        # packed per-channel record (type, dst_wg, lat), gathered once
        # per requester
        ch_tbl=torch.stack([d(net.ch_type), d(ch_dst_wg), d(net.ch_lat)],
                           dim=-1),
        inject_ch=d(net.inject_ch),
        term_node=d(net.term_node),
        term_wg=d(wg_tbl[net.term_node]),
        num_wg=net.meta["g"],
    )
    return consts, route_kernel


# additive UGAL congestion penalty per unit of W-group degradation (see
# the reference `state.UGAL_WG_PENALTY_SCALE`)
UGAL_WG_PENALTY_SCALE = 16


def build_lane(net: Network, cfg,
               faults: FaultSet | FaultSchedule | None = None, *,
               device) -> dict:
    """Per-lane fault data (the `fl` dict): alive masks + fault-dependent
    routing tables (+ adaptive-misroute tables for the non-minimal modes,
    + UGAL sensors when adaptive routing is on).

    With a `FaultSchedule` the lane is EPOCH-STACKED: every tensor
    carries a leading `[P]` epoch axis plus an `epoch_start [P]` int32
    vector, and the step selects each lane's epoch by cycle
    (`resolve_epoch`)."""
    if isinstance(faults, FaultSchedule):
        from ..routing import stack_epoch_dicts
        starts, fl = stack_epoch_dicts(
            [_build_epoch(net, cfg, f, device) for _, f in faults.epochs],
            (c for c, _ in faults.epochs))
        fl["epoch_start"] = starts
        return fl
    return _build_epoch(net, cfg, faults, device)


def _build_epoch(net: Network, cfg, faults: FaultSet | None, device) -> dict:
    """The flat (single-epoch) lane dict for one cold fault set."""
    from .inject import build_ugal_watch  # local import: step imports both
    faults = faults or FaultSet()
    fl = dict(
        ch_alive=as_tensor(faults.ch_alive(net), device),
        term_alive=as_tensor(faults.term_alive(net), device),
    )
    fl.update(route_tables(net, cfg.vc_mode, faults, device=device))
    if cfg.route_mode != "min":
        fl["glob_ok"] = as_tensor(glob_pair_alive(net, faults), device)
        frac = wg_channel_alive_frac(net, faults)
        fl["wg_penalty"] = as_tensor(
            np.round(UGAL_WG_PENALTY_SCALE * (1.0 - frac)).astype(np.int32),
            device)
    if cfg.route_mode == "ugal":
        fl["ugal_watch"] = build_ugal_watch(net, cfg, faults, device=device)
    return fl


def is_scheduled(fl: dict) -> bool:
    """True when the lane dict is epoch-stacked (carries `epoch_start`)."""
    return "epoch_start" in fl


def epoch_index(fl: dict, t: int | torch.Tensor) -> torch.Tensor:
    """Per-lane index ``[B]`` of the epoch in effect at cycle `t` for a
    lane-stacked scheduled `fl` (`epoch_start [B, P]`)."""
    return (t >= fl["epoch_start"]).sum(-1) - 1


def lane_epoch(fl: dict, idx: torch.Tensor) -> dict:
    """Slice each lane's epoch `idx[b]` out of a lane-stacked scheduled
    dict: ``[B, P, ...] -> [B, ...]``."""
    lane = torch.arange(idx.shape[0], device=idx.device)
    return {k: v[lane, idx] for k, v in fl.items() if k != "epoch_start"}


def resolve_epoch(fl: dict, t: int | torch.Tensor) -> dict:
    """The lanes' fault data in effect at cycle `t`: a no-op for flat
    (cold) lanes, a per-lane epoch gather for scheduled ones, so lanes
    carrying different schedules each see their own epoch."""
    if not is_scheduled(fl):
        return fl
    return lane_epoch(fl, epoch_index(fl, t))


def stack_lanes(lanes: list[dict], epochs: int | None = None) -> dict:
    """Stack per-lane fault dicts into one lane-axis dict [B, ...].

    Epoch-stacked lanes with differing epoch counts are padded to the
    longest schedule by repeating their final epoch with an unreachable
    onset cycle (`epochs` pins the padded count to at least that many)."""
    if lanes and is_scheduled(lanes[0]):
        P = max(int(l["epoch_start"].shape[0]) for l in lanes)
        if epochs is not None:
            P = max(P, epochs)
        lanes = [_pad_epochs(l, P) for l in lanes]
    return {k: torch.stack([l[k] for l in lanes]) for k in lanes[0]}


def _pad_epochs(fl: dict, P: int) -> dict:
    p = P - int(fl["epoch_start"].shape[0])
    if p == 0:
        return fl
    out = {k: torch.cat([v] + [v[-1:]] * p) for k, v in fl.items()
           if k != "epoch_start"}
    es = fl["epoch_start"]
    out["epoch_start"] = torch.cat(
        [es, torch.full((p,), INF32, dtype=torch.int32, device=es.device)])
    return out
