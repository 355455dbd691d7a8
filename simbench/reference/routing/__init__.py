"""Routing for the switch-less Dragonfly (paper Sec. IV) and the
switch-based baseline.

    vcs.py        VC schemes (`num_vcs`) + the packet meta bitfield
    tables.py     fault-dependent routing tables and their per-epoch
                  stacking for time-varying `FaultSchedule`s
    kernels/      one module per scheme, all obeying the lane-batched
                  `kernel(fl, cur, dest, mis, meta)` protocol
    pipeline.py   `RoutePipeline` + `make_route_kernel`
"""
from .vcs import num_vcs
from .tables import route_tables, share_lanes, stack_epoch_dicts
from .pipeline import make_route_kernel

__all__ = ["num_vcs", "route_tables", "share_lanes", "stack_epoch_dicts",
           "make_route_kernel"]
