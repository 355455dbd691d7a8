"""Device time of the cycle step's `step.grant` range, in ms a cycle: the
least-occupied-VC tables, the credit gather, the channels' eligibility
and the arbitration kernel.  Read from the eager phase segment of a
`--trace 1` run (`simbench/phases.py`)."""
from simbench import phases


def read(ctx):
    return phases.ms_per_cycle(ctx, "step.grant")
