"""`RoutePipeline`: the single protocol every route kernel plugs into.

A pipeline is (network, vc_mode,
kernel) where the kernel is a pure function

    kernel(fl, cur_node, dest_term, mis_wg, meta) -> (out_ch, req_vc, meta')

over ``[B, N]`` rows and the lane-stacked fault-dependent tables `fl`
(`tables.route_tables`, stacked or shared over lanes).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import torch

from ..topology import FaultSchedule, FaultSet, Network
from .kernels import (make_baseline_kernel, make_dragonfly_kernel,
                      make_updown_kernel)
from .tables import route_tables, share_lanes, stack_epoch_tables
from .vcs import num_vcs


@dataclass(frozen=True, eq=False)
class RoutePipeline:
    """One network's routing scheme as a pluggable pipeline stage."""

    net: Network = field(repr=False)
    vc_mode: str
    kernel: Callable = field(repr=False)
    device: torch.device = field(repr=False, default=None)

    def num_vcs(self, nonminimal: bool) -> int:
        """Deadlock classes this scheme needs (before `vcs_per_class`)."""
        return num_vcs(self.net.meta["kind"], self.vc_mode, nonminimal)

    def tables(self, faults: FaultSet | None = None) -> dict:
        """Fault-dependent tables for one epoch (pristine when None)."""
        return route_tables(self.net, self.vc_mode, faults,
                            device=self.device)

    def epoch_tables(self, schedule: FaultSchedule) -> tuple:
        """(epoch_start [P], epoch-stacked tables) for a warm schedule."""
        return stack_epoch_tables(self.net, self.vc_mode, schedule,
                                  device=self.device)

    def bind(self, faults: FaultSet | None = None):
        """4-argument closure over one epoch's tables, shared by every
        lane of the ``[B, N]`` rows it is called with."""
        fl = self.tables(faults)
        kernel = self.kernel
        return lambda cur, dest, mis, meta: kernel(
            share_lanes(fl, cur.shape[0]), cur, dest, mis, meta)

    def __call__(self, fl, cur, dest_term, mis_wg, meta):
        return self.kernel(fl, cur, dest_term, mis_wg, meta)


def make_pipeline(net: Network, vc_mode: str = "baseline", *,
                  device) -> RoutePipeline:
    """Kind-dispatched `RoutePipeline` for one network."""
    if net.meta["kind"] != "switchless":
        kernel = make_dragonfly_kernel(net, device)
    elif vc_mode == "baseline":
        kernel = make_baseline_kernel(net, device)
    elif vc_mode in ("updown", "updown_merged"):
        kernel = make_updown_kernel(net, vc_mode, device)
    else:
        raise ValueError(vc_mode)
    return RoutePipeline(net=net, vc_mode=vc_mode, kernel=kernel,
                         device=torch.device(device))


def make_route_kernel(net: Network, vc_mode: str = "baseline", *, device):
    """Returns kernel(fl, cur_node, dest_term, mis_wg, meta)
    -> (out_ch, req_vc, new_meta) (see `make_pipeline`)."""
    return make_pipeline(net, vc_mode, device=device).kernel


def make_route_fn(net: Network, vc_mode: str = "baseline",
                  faults: FaultSet | None = None, *, device):
    """Route closure route(cur, dest_term, mis_wg, meta) over the
    (possibly degraded) network's tables."""
    return make_pipeline(net, vc_mode, device=device).bind(faults)
