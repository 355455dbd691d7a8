"""Lane-batched simulation engine (port of `repro.core.engine`).

The cycle is decomposed into explicit phases over a `SimState` of tensors
with a leading lane dimension:

    inject    packet generation + misroute decision + source-queue push
    arbitrate routing, VC expansion, credit check, age-based grant
    apply     pops / pushes / misroute clearing / serialization
    stats     delivered / latency / hop accumulators

`step.make_step` wires them into one cycle function (the oracle,
`step_impl="jnp"`) or returns one of the fused steps of `fused.py`
("fused", "compact"); `step.run_scan` (one cycle a host-int step) and
`graphs.CycleGraph` (K-cycle supersteps of `step.superstep_body`, the
cycle index on the device, replayed as a captured CUDA graph on CUDA and
run eagerly on the CPU) are the cycle loops; `sweep.BatchedSweep` runs
a (rate x seed x fault) lane grid through them, at once or window by
window (`sweep.LaneSession`), and `sweep.run_scan_batched` is the
reference's public single-device batched scan, returning the final
state.
"""
from .state import (SimState, SimStats, build_consts, build_lane,
                    epoch_index, is_scheduled, lane_epoch, make_state,
                    resolve_device, resolve_epoch, stack_lanes)
from .arbitrate import Requests, make_arbitrate_fn
from .inject import (make_inject_fn, make_misroute_fn, build_ugal_watch,
                     ugal_queue_len)
from .apply import make_apply_fn
from .stats import accumulate, finalize, zero_stats
from .fused import (capacity_ladder, compact_rows, grant_form,
                    initial_capacity, make_compact_step, make_fused_step,
                    next_rung)
from .step import make_step, run_scan, superstep_body
from .sweep import (BatchedSweep, LaneRun, LaneSession, SweepResult,
                    clear_aot_cache, compile_counter, lane_mesh,
                    run_scan_batched, superstep)

__all__ = [
    "SimState", "SimStats", "Requests", "build_consts", "build_lane",
    "epoch_index", "is_scheduled", "lane_epoch", "resolve_device",
    "resolve_epoch", "make_state", "stack_lanes", "make_arbitrate_fn",
    "make_inject_fn", "make_misroute_fn", "build_ugal_watch",
    "ugal_queue_len", "make_apply_fn", "accumulate", "finalize",
    "zero_stats", "capacity_ladder", "compact_rows", "grant_form",
    "initial_capacity", "make_compact_step", "make_fused_step", "next_rung",
    "make_step", "run_scan", "superstep_body",
    "BatchedSweep", "LaneRun", "LaneSession", "SweepResult",
    "clear_aot_cache", "compile_counter", "lane_mesh", "run_scan_batched",
    "superstep",
]
