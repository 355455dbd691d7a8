"""Stats phase: delivered/latency/hop accumulators and the conversion of
raw counters into a `SimResult` (per sweep lane).

Every accumulator is per lane ``[B]``.
`lat_sum` is, as in the reference, an exact integer sum per cycle added
to a float32 accumulator.
"""
from __future__ import annotations

import torch

from ..tensors import lane_take
from ..topology import CH_TYPE_NAMES, EJECT, NUM_CH_TYPES
from .arbitrate import Requests
from .state import SimStats


def undeliverable_mask(req: Requests, ch_alive):
    """Head-of-line rows that can NEVER be granted in the current fault
    epoch: parked on the -1 non-channel, or requesting a channel the
    epoch's fault set killed (the reaper's candidate population)."""
    dead_out = ~lane_take(ch_alive, req.out)
    return req.valid & ((req.out < 0) | dead_out)


def reap_mask(req: Requests, t: int | torch.Tensor, reap_age: int,
              ch_alive):
    """The rows the router-death reaper drops this cycle: undeliverable
    head-of-line requests whose generation age reached the park age."""
    return undeliverable_mask(req, ch_alive) & ((t - req.itime) >= reap_age)


def accumulate(stats: SimStats, req: Requests, win, consts,
               t: int | torch.Tensor,
               reap=None, ch_alive=None) -> SimStats:
    """Fold this cycle's granted movements into the accumulators (see the
    reference for the `stranded` gauge's two definitions, reaper off/on)."""
    i32 = torch.int32
    w_ej = win & (req.otype == EJECT)
    delivered = stats.delivered + w_ej.sum(-1, dtype=i32)
    lat = torch.where(w_ej, t - req.itime, 0).sum(-1, dtype=i32)
    lat_sum = stats.lat_sum + lat.to(torch.float32)
    types = torch.arange(NUM_CH_TYPES, device=win.device)
    onehot = win[..., None] & (req.otype[..., None] == types)
    hops = stats.hops + onehot.sum(1, dtype=i32)
    if reap is None:
        parked = req.valid & (req.out < 0)
        return stats.replace(delivered=delivered, lat_sum=lat_sum,
                             hops=hops, stranded=parked.sum(-1, dtype=i32))
    parked = undeliverable_mask(req, ch_alive)
    stranded = (parked & ~reap).sum(-1, dtype=i32)
    reaped = stats.reaped + reap.sum(-1, dtype=i32)
    return stats.replace(delivered=delivered, lat_sum=lat_sum, hops=hops,
                         stranded=stranded, reaped=reaped)


def live_rows(state) -> torch.Tensor:
    """The number of LIVE request rows per lane ``[B]``: non-empty
    (channel, vc) buffers + non-empty source queues."""
    return ((state.b_count > 0).sum((1, 2), dtype=torch.int32)
            + (state.s_count > 0).sum(1, dtype=torch.int32))


def track_occ(stats: SimStats, state) -> SimStats:
    """Fold the current live-row count into the `occ_peak` high-water
    mark (called right after inject)."""
    return stats.replace(occ_peak=torch.maximum(stats.occ_peak,
                                                live_rows(state)))


def zero_stats(stats: SimStats) -> SimStats:
    """Warmup reset; `occ_peak` survives it (whole-run high-water mark)."""
    z = SimStats(**{k: torch.zeros_like(v)
                    for k, v in vars(stats).items()})
    return z.replace(occ_peak=stats.occ_peak)


def lane_stats(stats: SimStats, i: int) -> SimStats:
    """Lane i's counters (``[]``-shaped entries)."""
    return SimStats(**{k: v[i] for k, v in vars(stats).items()})


def finalize(stats: SimStats, cfg, offered_per_chip: float, chips: float):
    """Raw counters of ONE sweep lane (`lane_stats`) -> a `SimResult`."""
    from ..result import SimResult
    st = SimStats(**{k: v.cpu() for k, v in vars(stats).items()})
    delivered = int(st.delivered)
    thr = delivered * cfg.pkt_len / cfg.measure / max(chips, 1e-9)
    lat = float(st.lat_sum) / max(delivered, 1)
    hops = {name: int(st.hops[i]) for i, name in enumerate(CH_TYPE_NAMES)}
    avg_hops = {k: v / max(delivered, 1) for k, v in hops.items()}
    return SimResult(
        offered_per_chip=offered_per_chip, throughput_per_chip=thr,
        avg_latency=lat, delivered_pkts=delivered,
        generated_pkts=int(st.generated), dropped_pkts=int(st.dropped),
        hops_by_type=hops, avg_hops_by_type=avg_hops,
        stranded_pkts=int(st.stranded),
        stranded_mean=float(st.stranded),
        reaped_pkts=int(st.reaped),
        occupancy_peak=int(st.occ_peak))
