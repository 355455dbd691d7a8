"""The eager phase segment of a `--trace 1` run: the device time of each
phase of the cycle step, read by `inject_ms_per_cycle`,
`requests_ms_per_cycle`, `grant_ms_per_cycle` and `commit_ms_per_cycle`.

A replayed CUDA graph ties every kernel to one `cudaGraphLaunch`, so the
traced segment cannot say which phase of the step a kernel belongs to.
The program's steps open a profiler range around each phase
(`repro_torch.spans`: `step.inject`, `step.requests`, `step.grant`,
`step.commit`), but their Python runs only eagerly and at a capture.  So
this segment runs the jobs' own step eagerly: a `BatchedSweep(...,
loop="eager")` that shares the runner's sweep's step, tables and lane
data, over the lanes of the window's last job.  A windowed session on
the jobs' own sweep replays their graph through the warmup; its
`export()` is restored into the eager sweep (`start_lanes(...,
restore=)`), whose next window of `PHASE_CYCLES` cycles, at the
measured phase's load, runs under `torch.profiler`.  A phase's device
time is the profiler's attribution of kernels (and copies) to the range
that launched them.

The first reader to ask runs the segment, once a run: after the traced
segment and before the reference check, on any device.  Its readers
return None without a card (the CPU has no device time) and where the
program has no spans (`repro_torch.spans`), without running it there.
"""
from __future__ import annotations

import time
import weakref
from importlib.util import find_spec

import torch
from torch.autograd import DeviceType

from . import harness

PHASES = ("step.inject", "step.requests", "step.grant", "step.commit")
# the profiled window: enough cycles that a phase's time a cycle is
# steady, few enough that the profiler's events (about 1,250 kernels and
# 5,000 host operations a cycle) are read in seconds
PHASE_CYCLES = 10

# (the run's Context, its split): one segment a run
_LAST: list = [None, None]


def split(ctx) -> dict | None:
    """The run's phase split (see `measure`), measured on the first call
    for this `ctx`; None where the program has no spans."""
    ref, out = _LAST
    if ref is not None and ref() is ctx:
        return out
    out = (measure(ctx.config, ctx.traffic, ctx.jobs[-1].seeds, ctx.device)
           if find_spec("repro_torch.spans") else None)
    _LAST[:] = [weakref.ref(ctx), out]
    return out


def ms_per_cycle(ctx, phase: str) -> float | None:
    """`phase`'s device ms a cycle in the run's segment; None without
    device time (the CPU) or without spans."""
    out = split(ctx)
    if out is None or not out["device_s"]:
        return None
    return out["phases"][phase] * 1e3 / out["cycles"]


def measure(config: dict, traffic: dict, seeds: list, device) -> dict:
    """Run the segment on the lanes of a job with these seeds:
    ``{"cycles", "phases": {name: device s}, "device_s": all device
    time, "seconds": the segment's host seconds}``."""
    from repro_torch.core.engine.sweep import BatchedSweep
    from repro_torch.exp import runner
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    device = torch.device(device)
    spec = harness.job_spec(config, traffic, seeds, "phases")
    cell, = runner.cells(spec)
    jobs = runner.cell_sweep(cell, spec.axes, device)
    eager = BatchedSweep(cell.net, cell.cfg, cell.pattern, step=jobs.step,
                         consts=jobs.consts, lane=jobs.lane0, device=device,
                         loop="eager")
    lanes = [(r, s, None) for r in spec.axes.rates for s in seeds]
    # the warmup on the jobs' graph (a replay, not a capture), then its
    # state restored into the eager sweep
    warm = jobs.start_lanes(lanes, window=cell.cfg.warmup)
    warm.advance()
    session = eager.start_lanes(lanes, window=PHASE_CYCLES,
                                restore=warm.export())
    del warm
    harness._sync(device)
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    start, t_warm = session.cycle, time.perf_counter()
    with profile(activities=acts) as prof:
        session.advance()
        harness._sync(device)
    cycles, t_prof = session.cycle - start, time.perf_counter()
    del session, eager
    phases = dict.fromkeys(PHASES, 0.0)
    for e in prof.events():
        if e.name in phases and e.device_type == DeviceType.CPU:
            phases[e.name] += e.device_time_total * 1e-6
    device_ns = sum(e.duration_ns()
                    for e in prof.profiler.kineto_results.events()
                    if e.device_type() == DeviceType.CUDA
                    and not e.is_user_annotation())
    out = dict(cycles=cycles, phases=phases, device_s=device_ns * 1e-9,
               seconds=time.perf_counter() - t0)
    inside = sum(phases.values())
    harness._log(
        f"phase segment of {cycles} cycles: " + ", ".join(
            f"{k} {v * 1e3 / cycles} ms" for k, v in phases.items())
        + f" a cycle; device time {out['device_s']} s, "
        f"{out['device_s'] - inside} s of it outside the phases; "
        f"{out['seconds']} s: {t_warm - t0} s to the measured phase, "
        f"{t_prof - t_warm} s profiled, the rest reading")
    return out

