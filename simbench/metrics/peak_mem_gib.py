"""`torch.cuda.max_memory_allocated()` over set-up and the window, in
GiB: the memory held a lane bounds the lanes one dispatch can hold."""


def read(ctx):
    if not ctx.memory_peak_bytes:
        return None
    return ctx.memory_peak_bytes / 2**30
