"""Summed device kernel time in the traced segment over its cycles, in
ms."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels:
        return None
    ns = sum(end - start for _, _, start, end in ctx.trace.kernels)
    return ns * 1e-6 / ctx.trace.cycles
