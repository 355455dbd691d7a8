"""One benchmark run of a cell: set-up, the measured window, the traced
segment and the output check, over the program's public experiment entry
`repro_torch.exp.runner.run_experiment`.

A cell is a configuration file (the network and its routers, the cycle
budget) under a traffic file (the pattern, the routing, the lane grid of
offered rates x seeds).  A job is one `ExperimentSpec` of that cell: one
batched dispatch of every (rate, seed) lane.  The run:

1. set-up: imports, CUDA start, the kernel library's build or load, the
   network and its tables, the sweep, and its CUDA graph captured at the
   cell's own lane shape (`warm`), so that the window replays it;
2. the window: jobs back to back (one caller, a closed loop) until
   `seconds` have passed; it ends with the last job's counters on the
   host.  Every job draws fresh lane seeds from the run's seed and its
   index, but keeps the run's first lane seed: the runner keys its sweep
   cache on a grid's first seed, and a new one would build a new step
   and capture anew inside the window;
3. with ``trace``: a profiled window of `TRACE_CYCLES` cycles of a
   windowed session on the same sweep, which replays the same graph (see
   `_traced_segment`);
4. the check: a sample of the window's lanes, one for each (rate, seed
   slot) of a job, each from a job drawn from the run's seed, run again
   by the plain reference (`simbench.reference`) once the program's
   state is freed, and compared counter for counter (`check.compare`).

`run_cell` takes the device, so the tests drive it on the CPU; only
`run.py` looks for the card.
"""
from __future__ import annotations

import gc
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch
from torch.autograd import DeviceType

from . import check as check_mod
from . import reference
from .roofline import H100_BYTES_PER_S, cycle_shapes

# cycles of the traced segment: enough replays that the segment's
# per-cycle numbers are steady, few enough that the profiler's events
# (about 1,250 kernels a cycle) are read in a few seconds
TRACE_CYCLES = 100
# the profiler annotation that bounds the traced segment
WINDOW = "simbench.window"
TRAFFIC_KEYS = {"pattern", "params", "route_mode", "step_impl", "rates",
                "seeds_per_rate", "why"}


@dataclass
class Job:
    """One dispatched (rate x seed) grid of the window."""

    index: int
    seeds: list
    wall_s: float          # the runner's own clock of the grid's run
    compile_s: float       # its capture seconds (0.0 on a cache hit)
    results: list          # [rates][seeds] of the program's SimResult


@dataclass
class Trace:
    """The profiled segment: its bounds on the profiler's clock, the
    device operations and the host operations in it."""

    start_ns: int
    end_ns: int
    cycles: int
    device_ops: list       # (name, activity, start_ns, end_ns)
    host_ops: list         # (name, start_ns, end_ns)

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    @property
    def kernels(self) -> list:
        return [op for op in self.device_ops if op[1] == "kernel"]

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals, clipped to the
        segment, as sorted disjoint (start_ns, end_ns) pairs."""
        spans = sorted((max(s, self.start_ns), min(e, self.end_ns))
                       for _, _, s, e in self.device_ops)
        out = []
        for s, e in spans:
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [tuple(x) for x in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9


@dataclass
class Context:
    """What a metric reader (``simbench/metrics/<name>.py``) reads."""

    config: dict
    traffic: dict
    device: torch.device
    setup_s: float
    jobs: list
    window_s: float
    lane_cycles: int
    captures_in_window: int
    memory_peak_bytes: int
    shapes: dict
    trace: Trace | None = None
    peak_bytes_per_s: float = H100_BYTES_PER_S


def check_traffic(traffic: dict) -> None:
    """Refuse a traffic file with keys this harness does not read."""
    unknown = set(traffic) - TRAFFIC_KEYS
    if unknown:
        raise ValueError(f"traffic file keys not read by the harness: "
                         f"{sorted(unknown)}")


def lane_seeds(seed: int, job: int, per_rate: int) -> list:
    """The lane seeds of job `job` (0 is the warm job) of a run: the run's
    first seed, shared by every job, then ``per_rate - 1`` fresh ones."""
    base = int(seed) % 2**63
    first = int(np.random.default_rng([base, 0]).integers(0, 2**31))
    rest = np.random.default_rng([base, job + 1]).integers(
        0, 2**31, per_rate - 1)
    return [first] + [int(s) for s in rest]


def job_spec(config: dict, traffic: dict, seeds: list, name: str):
    """The `ExperimentSpec` of one job of the cell."""
    from repro_torch.exp.spec import (ExperimentSpec, RoutingSpec,
                                      SweepAxes, TopologySpec, TrafficSpec)
    topo = dict(config["topology"])
    kind = topo.pop("kind")
    return ExperimentSpec(
        name=name,
        topologies=TopologySpec(kind, tuple(topo.items())),
        traffics=TrafficSpec(traffic["pattern"],
                             tuple(traffic.get("params", {}).items())),
        routings=RoutingSpec(
            route_mode=traffic["route_mode"], vc_mode=config["vc_mode"],
            vcs_per_class=config["vcs_per_class"],
            pkt_len=config["pkt_len"], buf_pkts=config["buf_pkts"],
            srcq_pkts=config["srcq_pkts"], step_impl=traffic["step_impl"]),
        axes=SweepAxes(rates=tuple(traffic["rates"]), seeds=tuple(seeds),
                       warmup=config["warmup"], measure=config["measure"]))


def _log(msg: str) -> None:
    print(f"[simbench] {msg}", file=sys.stderr, flush=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_job(config, traffic, seed, index, device) -> Job:
    from repro_torch.exp.runner import run_experiment
    seeds = lane_seeds(seed, index, traffic["seeds_per_rate"])
    res = run_experiment(job_spec(config, traffic, seeds, f"job{index}"),
                         device=device)
    grid, = res.grids
    return Job(index, seeds, res.wall_s, res.compile_s, grid.results[0])


def cell_sweep(config, traffic, seeds, device):
    """The runner's cached sweep of the cell (made on a miss) and the
    lanes of a job with these lane seeds, in the runner's order."""
    from repro_torch.exp import runner
    spec = job_spec(config, traffic, seeds, "cell")
    cell, = runner.cells(spec)
    lanes = [(r, s, None) for r in spec.axes.rates for s in seeds]
    return runner.cell_sweep(cell, spec.axes, device), lanes


def warm(config, traffic, seed, device) -> None:
    """Set-up's warm-up: the runner's sweep of the cell and its captured
    graph at the cell's lane shape (`BatchedSweep.warm_compile`, the
    runner's own first pass), without running the job's cycles."""
    seeds = lane_seeds(seed, 0, traffic["seeds_per_rate"])
    sweep, lanes = cell_sweep(config, traffic, seeds, device)
    sweep.warm_compile(lanes)


def _traced_segment(config, traffic, seed, device) -> Trace:
    """Profile `TRACE_CYCLES` cycles of the cell's lanes at the measured
    phase's load.  A windowed session (`BatchedSweep.start_lanes`) on the
    sweep the jobs ran through has the jobs' graph key (step, lane count,
    state and lane-data signatures), so it replays the same captured
    graph: the profiled window holds the session's host key chain for its
    cycles, the state copied in, the replays and the state copied out."""
    from torch.profiler import ProfilerActivity, profile, record_function
    seeds = lane_seeds(seed, 10**6, traffic["seeds_per_rate"])
    sweep, lanes = cell_sweep(config, traffic, seeds, device)
    session = sweep.start_lanes(lanes, window=TRACE_CYCLES)
    while session.cycle < config["warmup"] and not session.done():
        session.advance()
    _sync(device)
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    start = session.cycle
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            session.advance()
            _sync(device)
    cycles = session.cycle - start
    del session
    t0 = t1 = None
    dev_ops, host_ops = [], []
    for e in prof.profiler.kineto_results.events():
        name, (start, end) = e.name(), _bounds(e)
        on_device = e.device_type() == DeviceType.CUDA
        if name == WINDOW:
            if not on_device:
                t0, t1 = start, end
        elif on_device:
            kind = ("gpu_memcpy" if name.startswith("Memcpy") else
                    "gpu_memset" if name.startswith("Memset") else "kernel")
            dev_ops.append((name, kind, start, end))
        else:
            host_ops.append((name, start, end))
    return Trace(t0, t1, cycles, dev_ops, host_ops)


def _bounds(event) -> tuple:
    """A profiler event's (start, end) in ns on the profiler's clock."""
    if hasattr(event, "start_ns"):
        start = event.start_ns()
        return start, start + event.duration_ns()
    start = int(event.start_us() * 1000)
    return start, start + int(event.duration_us() * 1000)


def _free_program_state() -> None:
    from repro_torch.core.engine import sweep
    from repro_torch.exp import runner
    runner.clear_caches()
    sweep.clear_aot_cache()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def check_sample(seed: int, jobs: list, rates: list) -> list:
    """(job, rate index, seed slot) for every (rate, seed slot) of a job,
    each from a job of the window drawn from the run's seed."""
    rng = np.random.default_rng([int(seed) % 2**63, 2**32])
    S = len(jobs[0].seeds)
    picks = rng.integers(0, len(jobs), len(rates) * S)
    return [(jobs[int(p)], i // S, i % S) for i, p in enumerate(picks)]


def run_check(config, traffic, seed, jobs, device) -> dict:
    """The sampled lanes run again by the reference and compared."""
    rates = list(traffic["rates"])
    sample = check_sample(seed, jobs, rates)
    lanes = [(rates[ri], job.seeds[si]) for job, ri, si in sample]
    want = reference.simulate(config, traffic, lanes, device=device)
    got = [job.results[ri][si] for job, ri, si in sample]
    return check_mod.compare(got, want)


def run_cell(config: dict, traffic: dict, *, seed: int, seconds: float,
             trace: bool, device, readers: dict, t_start: float) -> dict:
    """One run of the cell: returns the result line's object (see
    `run.py`).  `readers` maps each metric name the line reports to its
    (reader, unit); `t_start` is the process's start on the host clock."""
    check_traffic(traffic)
    device = torch.device(device)
    from repro_torch.core.engine import graphs
    # set-up: the cell's sweep and its captured graph
    warm(config, traffic, seed, device)
    _sync(device)
    setup_s = time.perf_counter() - t_start
    # the measured window
    captures0 = graphs.captures()
    jobs = []
    t0 = time.perf_counter()
    while not jobs or time.perf_counter() - t0 < seconds:
        t_job = time.perf_counter()
        jobs.append(run_job(config, traffic, seed, len(jobs) + 1, device))
        _log(f"job {len(jobs)}: {time.perf_counter() - t_job} s, runner "
             f"wall_s {jobs[-1].wall_s}, compile_s {jobs[-1].compile_s}")
    window_s = time.perf_counter() - t0
    captures = graphs.captures() - captures0
    B = len(traffic["rates"]) * traffic["seeds_per_rate"]
    lane_cycles = len(jobs) * B * (config["warmup"] + config["measure"])
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    ctx = Context(config, traffic, device, setup_s, jobs, window_s,
                  lane_cycles, captures, peak, cycle_shapes(config, traffic,
                                                            B))
    if trace:
        t_trace = time.perf_counter()
        ctx.trace = _traced_segment(config, traffic, seed, device)
        _log(f"traced segment of {ctx.trace.cycles} cycles: "
             f"{len(ctx.trace.device_ops)} device and "
             f"{len(ctx.trace.host_ops)} host operations, "
             f"{time.perf_counter() - t_trace} s with reading")
    metrics = {}
    for name, (read, unit) in readers.items():
        value = read(ctx)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    _free_program_state()
    t_check = time.perf_counter()
    checked = run_check(config, traffic, seed, jobs, device)
    _log(f"reference check: {time.perf_counter() - t_check} s")
    return dict(metrics=metrics, attempted=len(jobs) * B,
                failed=checked["lanes_differing"]["value"],
                correct=check_mod.passes(checked), check=checked,
                trace=ctx.trace, window_s=window_s, jobs=len(jobs),
                setup_s=setup_s, memory_peak_bytes=peak)
