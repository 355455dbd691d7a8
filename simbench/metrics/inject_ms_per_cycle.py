"""Device time of the cycle step's `step.inject` range, in ms a cycle:
threefry's draws and the new packets pushed into the source queues.
Read from the eager phase segment of a `--trace 1` run
(`simbench/phases.py`)."""
from simbench import phases


def read(ctx):
    return phases.ms_per_cycle(ctx, "step.inject")
