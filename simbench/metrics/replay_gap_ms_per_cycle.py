"""The device's idle time while the host replays the cycle graph, in ms
a cycle: the idle between kernels inside a replayed graph, and replays
the host issued late.  Each `graph.replays` range of the traced segment
(the program's span around a run's or window's replay loop,
`repro_torch.spans`) counts from its start to the end of the device's
last operation before the next `sweep.key_chain` range (or the
segment's end), since the host issues replays ahead of the device; the
idle is that interval less the device's busy intervals.  Read from the
trace's host operations and busy intervals alone."""

REPLAYS, CHAIN = "graph.replays", "sweep.key_chain"


def read(ctx):
    trace = ctx.trace
    if trace is None or not trace.device_ops:
        return None
    replays = sorted(s for name, s, _ in trace.host_ops if name == REPLAYS)
    if not replays:
        return None
    chains = sorted(s for name, s, _ in trace.host_ops if name == CHAIN)
    busy = trace.busy_intervals()
    idle = 0
    for start in replays:
        stop = min([s for s in chains if s > start] + [trace.end_ns])
        end = max([e for _, _, s, e in trace.device_ops
                   if start <= s < stop] + [start])
        end = min(end, trace.end_ns)
        covered = sum(max(0, min(end, e) - max(start, s)) for s, e in busy)
        idle += end - start - covered
    return idle * 1e-6 / trace.cycles
