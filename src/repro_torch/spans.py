"""Named host spans over the port's sweep and cycle step.

    with span("sweep.key_chain"):
        ...

Every span adds its host seconds (`time.perf_counter`) and one count to
a per-process table; `totals()` returns a copy, ``{name: (count,
seconds)}``, and a caller takes the difference of two readings, as with
`graphs.captures()`.  While a `torch.profiler` is recording, the span
also opens a profiler range of its name, so its start, end and parent
land in the trace on the same clock as the device's kernels, and each
kernel and idle gap can be put down to the span that issued it.  With
no profiler recording it opens nothing (a check of about 0.2 us; a
range costs microseconds even then).

The range is an operator's (`torch._C._profiler._RecordFunctionFast`),
not a user annotation (`torch.profiler.record_function`): the profiler
gives a user annotation a twin on the device's timeline that spans
every kernel launched inside it, which a reader of the device's events
would take for device work.  An operator's range has no twin, and the
kernels launched inside it are still attributed to it.

A span never synchronises the device: its seconds are the host's time
issuing the work, not the device's time doing it.  On CUDA a span around
launched kernels ends while they still run; the kernels' own time is the
profiler's attribution of them to the range.

The names in use: `sweep.key_chain` (the subkey chain of a dispatch or
window, `engine.step.key_chain`: on a CUDA key the host's time issuing
its one launch, on a CPU key the host drawing it), `graph.copy` (a
`CycleGraph`'s inputs copied in and its results copied out),
`graph.replays` (a run's or window's replay loop) and the cycle step's
phases `step.inject`, `step.requests`, `step.grant`, `step.commit`
(`engine.fused`), and `route.misroute` (the misroute decision of
`engine.inject`: Valiant's candidate draw, the fault mask, UGAL's sensor
gathers and the choice), which lies inside `step.inject` in the steps
that have phases; the step's spans run their Python eagerly and at a
capture, never at a replay.  On the card no other span encloses
another, so a trace names each idle gap by the one range that overlaps
it; on the CPU the graph loop runs the step eagerly inside
`graph.replays`.
"""
from __future__ import annotations

import time

import torch

# name -> [count, seconds]
_TOTALS: dict = {}
_recording = torch._C._autograd._profiler_enabled
_RecordFunctionFast = torch._C._profiler._RecordFunctionFast


def totals() -> dict:
    """A copy of the per-process table: ``{name: (count, seconds)}``."""
    return {k: (c, s) for k, (c, s) in _TOTALS.items()}


class span:
    """``with span(name):`` counts `name` and adds its host seconds; a
    profiler range while a profiler records (see the module docstring)."""

    __slots__ = ("name", "_t0", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = (_RecordFunctionFast(self.name) if _recording()
                       else None)
        if self._range is not None:
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        dt = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(None, None, None)
        entry = _TOTALS.get(self.name)
        if entry is None:
            entry = _TOTALS[self.name] = [0, 0.0]
        entry[0] += 1
        entry[1] += dt
