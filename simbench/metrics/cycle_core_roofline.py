"""The arbitration kernel's share of its byte bound, in %: the
`cycle_core` bytes at the cell's shapes (`roofline.cycle_core_bytes`) at
the card's peak bandwidth, over the device time of one call of the
kernels the trace lists for it (the cooperative kernel, or the
three-pass kernel's fill, accumulate and emit: one call a cycle)."""
import re

from simbench.roofline import cycle_core_bytes

ARBITRATION = re.compile(r"cycle_core_rows|\bcycle_(fill|accumulate|emit)\b")


def read(ctx):
    if ctx.trace is None or ctx.traffic["step_impl"] not in ("fused",
                                                             "compact"):
        return None
    ops = [op for op in ctx.trace.kernels if ARBITRATION.search(op[0])]
    if not ops:
        return None
    per_call_s = sum(end - start for _, _, start, end in ops) * 1e-9 \
        / ctx.trace.cycles
    s = ctx.shapes
    nbytes = cycle_core_bytes(s["B"], s["N"], s["E"],
                              prio=ctx.traffic["step_impl"] == "compact")
    return 100.0 * nbytes / ctx.peak_bytes_per_s / per_call_s
