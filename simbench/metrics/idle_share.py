"""1 - the union of the device operations' intervals over the traced
segment, in %: the idle time the host (the key chain) and the graph's
gaps between dependent kernels impose."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device_ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
