"""An eager segment of the cycle step, like the phase segment
(`simbench/phases.py`), that reads the device time under any of the
program's profiler ranges (`repro_torch.spans`) and how often each
opened.  `misroute_ms_per_cycle` reads `route.misroute` from it.

The segment is the phase segment's: the window's last job's lanes on a
`BatchedSweep(..., loop="eager")` that shares the runner's sweep's step,
tables and lane data, its warmup replayed on the jobs' own graph and its
state restored, then `phases.PHASE_CYCLES` eager cycles at the measured
phase's load under `torch.profiler`.  A range's device time is the
profiler's attribution of kernels (and copies) to it.
"""
from __future__ import annotations

import time

import torch
from torch.autograd import DeviceType

from . import harness, phases


def measure(ctx, names: tuple) -> dict:
    """Run the segment on the lanes of the run's last job: ``{"cycles",
    "counts": {name: ranges opened}, "device": {name: device s},
    "device_s": all device time}``."""
    from repro_torch.core.engine.sweep import BatchedSweep
    from repro_torch.exp import runner
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    device = torch.device(ctx.device)
    seeds = ctx.jobs[-1].seeds
    spec = harness.job_spec(ctx.config, ctx.traffic, seeds, "ranges")
    cell, = runner.cells(spec)
    jobs = runner.cell_sweep(cell, spec.axes, device)
    eager = BatchedSweep(cell.net, cell.cfg, cell.pattern, step=jobs.step,
                         consts=jobs.consts, lane=jobs.lane0, device=device,
                         loop="eager")
    lanes = [(r, s, None) for r in spec.axes.rates for s in seeds]
    warm = jobs.start_lanes(lanes, window=cell.cfg.warmup)
    warm.advance()
    session = eager.start_lanes(lanes, window=phases.PHASE_CYCLES,
                                restore=warm.export())
    del warm
    harness._sync(device)
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    start = session.cycle
    with profile(activities=acts) as prof:
        session.advance()
        harness._sync(device)
    cycles = session.cycle - start
    del session, eager
    counts = dict.fromkeys(names, 0)
    device_s = dict.fromkeys(names, 0.0)
    for e in prof.events():
        if e.name in counts and e.device_type == DeviceType.CPU:
            counts[e.name] += 1
            device_s[e.name] += e.device_time_total * 1e-6
    total_ns = sum(e.duration_ns()
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA
                   and not e.is_user_annotation())
    harness._log(
        f"range segment of {cycles} cycles: " + ", ".join(
            f"{k} {counts[k]} ranges, {v * 1e3 / max(cycles, 1)} ms a cycle"
            for k, v in device_s.items())
        + f"; {time.perf_counter() - t0} s")
    return dict(cycles=cycles, counts=counts, device=device_s,
                device_s=total_ns * 1e-9)
