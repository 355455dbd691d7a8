"""Device time of the program's `route.misroute` range, in ms a cycle:
the misroute decision inside `step.inject` (Valiant's candidate draw,
the fault mask on `glob_ok`, UGAL-G's sensor gathers over `ugal_watch`
and `b_count`, and the choice).  Read from an eager segment of the
jobs' step (`simbench/span_segment.py`) of a `--trace 1` run.  None
without a card (the CPU has no device time), without the program's
spans, and where the segment holds no `route.misroute` range (a program
without that span)."""
from importlib.util import find_spec

from simbench import phases, span_segment

NAME = "route.misroute"


def read(ctx):
    if not find_spec("repro_torch.spans"):
        return None
    # the phases too, for the segment's log line: route.misroute's share
    # of step.inject
    out = span_segment.measure(ctx, phases.PHASES + (NAME,))
    if not out["device_s"] or not out["counts"][NAME]:
        return None
    return out["device"][NAME] * 1e3 / out["cycles"]
