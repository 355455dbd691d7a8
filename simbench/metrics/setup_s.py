"""Seconds from the process's start to the end of the warm job: imports,
CUDA start-up, the kernel library's build or load, the network and its
tables, the sweep, and one job at the cell's lane shape (its capture
included)."""


def read(ctx):
    return ctx.setup_s
