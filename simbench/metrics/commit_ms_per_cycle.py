"""Device time of the cycle step's `step.commit` range, in ms a cycle: the
winner table, the push into the buffers, the pops, the state update and
the stats.  Read from the eager phase segment of a `--trace 1` run
(`simbench/phases.py`)."""
from simbench import phases


def read(ctx):
    return phases.ms_per_cycle(ctx, "step.commit")
