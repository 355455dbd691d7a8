"""Routing for the switch-less Dragonfly (paper Sec. IV) and the
switch-based baseline (port of `repro.core.routing`).

    vcs.py        VC schemes (`num_vcs`) + the packet meta bitfield
    tables.py     fault-dependent routing tables and their per-epoch
                  stacking for time-varying `FaultSchedule`s
    kernels/      one module per scheme, all obeying the lane-batched
                  `kernel(fl, cur, dest, mis, meta)` protocol
    pipeline.py   `RoutePipeline` + `make_route_kernel` / `make_route_fn`
    verify.py     offline path tracing, the channel-dependency graph and
                  the deadlock-freedom proofs (per fault set, per epoch of
                  a schedule, and across its transitions)
"""
from .vcs import (PHASE_BIT, meta_cg_count, meta_g_count, meta_update,
                  meta_via_ext, num_vcs)
from .tables import (build_updown_tables, route_tables, share_lanes,
                     stack_epoch_dicts, stack_epoch_tables)
from .pipeline import (RoutePipeline, make_pipeline, make_route_fn,
                       make_route_kernel)
from .verify import (ChannelDependencyGraph, assert_deadlock_free,
                     assert_schedule_deadlock_free, assert_transition_safe,
                     build_cdg, trace_paths)

__all__ = [
    "PHASE_BIT", "meta_cg_count", "meta_g_count", "meta_update",
    "meta_via_ext", "num_vcs",
    "build_updown_tables", "route_tables", "share_lanes",
    "stack_epoch_dicts", "stack_epoch_tables",
    "RoutePipeline", "make_pipeline", "make_route_fn", "make_route_kernel",
    "ChannelDependencyGraph", "assert_deadlock_free",
    "assert_schedule_deadlock_free", "assert_transition_safe", "build_cdg",
    "trace_paths",
]
