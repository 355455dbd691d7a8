"""The port's spans (`repro_torch.spans`) on the CPU.

A span counts and adds its host seconds and enters no profiler range
while no profiler records; under `torch.profiler` one eager cycle of the
fused and of the compact step yields the four `step.*` ranges, with every
aten op of the step under exactly one of them, and one `route.misroute`
range inside `step.inject`; a dispatch ticks `sweep.key_chain` once and
a window of a session once; and the rows of a sweep are the same with a
profiler recording.

The file imports neither jax nor the reference package.
"""
import dataclasses

import pytest
torch = pytest.importorskip("torch")

from repro_torch import spans
from repro_torch.core import topology as T
from repro_torch.core import traffic
from repro_torch.core.engine.step import key_chain
from repro_torch.core.engine.sweep import BatchedSweep
from repro_torch.core.simulator import SimConfig

PHASES = ("step.inject", "step.requests", "step.grant", "step.commit")
PARAMS = dict(a=1, b=1, m=2, n=6, noc=2, g=3)
CFG = SimConfig(warmup=20, measure=40, vcs_per_class=2, step_impl="fused")
LANES = [(1.2, 3, None), (2.2, 4, None)]


@pytest.fixture(scope="module")
def net():
    return T.build_switchless(T.SwitchlessParams(**PARAMS), "spans")


def _sweep(net, impl="fused", loop=None):
    cfg = dataclasses.replace(CFG, step_impl=impl)
    return BatchedSweep(net, cfg, traffic.uniform(net), device="cpu",
                        loop=loop)


def _delta(before, name):
    c0, s0 = before.get(name, (0, 0.0))
    c1, s1 = spans.totals().get(name, (0, 0.0))
    return c1 - c0, s1 - s0


def test_span_counts_and_adds_seconds_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a profiler range ({name!r}) with no "
                             f"profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(spans, "_RecordFunctionFast", refuse)
    before = spans.totals()
    for _ in range(3):
        with spans.span("test.outer"):
            sum(range(20000))
    n, s = _delta(before, "test.outer")
    assert n == 3 and s > 0
    # totals() is a copy
    spans.totals()["test.outer"] = (0, 0.0)
    assert spans.totals()["test.outer"][0] >= 3


def test_span_is_a_profiler_range_while_one_records():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with spans.span("test.recorded"):
            torch.ones(4).add_(1)
    names = [e.name for e in prof.events()]
    assert names.count("test.recorded") == 1
    # an operator's range, not a user annotation (which has a twin on the
    # device's timeline)
    kinds = {e.name(): e.is_user_annotation()
             for e in prof.profiler.kineto_results.events()}
    assert kinds["test.recorded"] is False


def _ancestors(event) -> list:
    """The names of an event's enclosing ranges, innermost first."""
    out, e = [], event.cpu_parent
    while e is not None:
        out.append(e.name)
        e = e.cpu_parent
    return out


def _phase_of(event) -> list:
    """The `step.*` ranges among an event's ancestors."""
    return [name for name in _ancestors(event) if name in PHASES]


@pytest.mark.parametrize("impl", ["fused", "compact"])
def test_each_aten_op_of_a_cycle_lies_under_one_phase(net, impl):
    sweep = _sweep(net, impl, loop="eager")
    session = sweep.start_lanes(LANES, window=CFG.warmup)
    session.advance()                     # traffic in flight
    ch = session.chunks[0]
    sub = key_chain(session.keys, 1)[1][0]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        ch.step(ch.state, (session.cycle, sub, ch.rates, ch.lanes))
    events = prof.events()
    assert sorted(e.name for e in events if e.name in PHASES) == \
        sorted(PHASES)
    ops = [e for e in events if e.name.startswith("aten::")]
    assert ops
    assert all(len(_phase_of(e)) == 1 for e in ops), \
        [(e.name, _phase_of(e)) for e in ops if len(_phase_of(e)) != 1]
    # every phase issues work of its own
    assert {_phase_of(e)[0] for e in ops} == set(PHASES)


@pytest.mark.parametrize("route_mode", ["min", "ugal"])
@pytest.mark.parametrize("impl", ["fused", "compact"])
def test_misroute_opens_once_a_cycle_inside_inject(net, impl, route_mode):
    cfg = dataclasses.replace(CFG, step_impl=impl, route_mode=route_mode)
    sweep = BatchedSweep(net, cfg, traffic.worst_case(net), device="cpu",
                         loop="eager")
    session = sweep.start_lanes(LANES, window=CFG.warmup)
    session.advance()
    ch = session.chunks[0]
    subs = key_chain(session.keys, 2)[1]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for i, sub in enumerate(subs):
            ch.state, _ = ch.step(ch.state, (session.cycle + i, sub,
                                             ch.rates, ch.lanes))
    events = prof.events()
    ranges = [e for e in events if e.name == "route.misroute"]
    assert len(ranges) == len(subs)
    assert all(_ancestors(e).count("step.inject") == 1 for e in ranges)
    under = [e for e in events if e.name.startswith("aten::")
             and "route.misroute" in _ancestors(e)]
    assert under and all("step.inject" in _ancestors(e) for e in under)


def test_dispatch_and_window_each_tick_the_key_chain_once(net):
    sweep = _sweep(net)
    before = spans.totals()
    sweep.run_lanes(LANES)
    sweep.run_lanes(LANES)
    assert _delta(before, "sweep.key_chain")[0] == 2
    # on the CPU the graph loop runs its supersteps eagerly: one replay
    # loop a run, its inputs copied in and its counters copied out
    assert _delta(before, "graph.replays")[0] == 2
    assert _delta(before, "graph.copy")[0] == 4
    session = sweep.start_lanes(LANES, window=25)
    before = spans.totals()
    windows = 0
    while not session.done():
        session.advance()
        windows += 1
    assert windows == 3
    assert _delta(before, "sweep.key_chain")[0] == windows
    assert _delta(before, "graph.replays")[0] == windows


def test_rows_are_unchanged_under_a_profiler(net):
    plain = _sweep(net).run([1.2, 2.2], seeds=(3, 4))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        traced = _sweep(net).run([1.2, 2.2], seeds=(3, 4))
    assert [dataclasses.asdict(r) for r in plain.flat()] == \
        [dataclasses.asdict(r) for r in traced.flat()]


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["fused", "compact"])
def test_each_kernel_of_a_cycle_lies_under_one_phase_on_the_card(net, impl):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CPU has no device time")
    dev = torch.device("cuda")
    cfg = dataclasses.replace(CFG, step_impl=impl)
    sweep = BatchedSweep(net, cfg, traffic.uniform(net), device=dev,
                         loop="eager")
    session = sweep.start_lanes(LANES, window=CFG.warmup)
    session.advance()
    ch = session.chunks[0]
    sub = key_chain(session.keys, 1)[1][0].to(dev)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        ch.step(ch.state, (session.cycle, sub, ch.rates, ch.lanes))
        torch.cuda.synchronize()
    phases = sum(e.device_time_total for e in prof.events()
                 if e.name in PHASES)
    device = sum(e.duration_ns() for e in
                 prof.profiler.kineto_results.events()
                 if e.device_type() == torch.autograd.DeviceType.CUDA
                 and not e.is_user_annotation()) * 1e-3
    # the benchmark's bar: under 2 % of the device time outside a phase
    assert device > 0 and phases == pytest.approx(device, rel=0.02), \
        (phases, device)
