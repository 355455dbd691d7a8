"""Device time of the cycle step's `step.requests` range, in ms a cycle:
the head and source-queue gathers, the request rows, their validity and
the reaper; in the compact step, the live-row compaction too.  Read from
the eager phase segment of a `--trace 1` run (`simbench/phases.py`)."""
from simbench import phases


def read(ctx):
    return phases.ms_per_cycle(ctx, "step.requests")
