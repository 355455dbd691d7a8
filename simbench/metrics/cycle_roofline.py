"""The whole cycle's share of the arbitration's byte bound, in %: the
same `cycle_core` bytes a cycle, from the cell's shapes alone, at the
card's peak bandwidth, over the traced segment's wall time a cycle.  It
reads the same work whatever implements the cycle, so it still bounds a
gain after the arbitration kernel is renamed or taken off the path."""
from simbench.roofline import cycle_core_bytes


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels:
        return None
    s = ctx.shapes
    nbytes = cycle_core_bytes(s["B"], s["N"], s["E"],
                              prio=ctx.traffic["step_impl"] == "compact")
    per_cycle_s = ctx.trace.window_s / ctx.trace.cycles
    return 100.0 * nbytes / ctx.peak_bytes_per_s / per_cycle_s
