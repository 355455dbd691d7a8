"""The cycle loop as captured CUDA graphs (`repro_torch.core.engine.graphs`)
on the card (marker `cuda`; they skip where `torch.cuda.is_available()` is
false: a CUDA graph has no CPU mode).

A captured run equals the eager loop bit for bit for all three steps at
K in {1, 2, 4} with cold and warm faults and the reaper; a second sweep
captures nothing; a compact escalation re-captures once; a capture that
fails raises and falls back to nothing; `Simulator.run` replays a graph
too; windowed sessions replay them (a tail shorter than K on a K = 1
graph) and equal the eager loop, and two sessions of one signature
interleave on one graph; n replays of a graph holding the netsim coop
kernel equal n eager calls (the kernel keeps its call parity and barrier
count on the device); and every netsim kernel
counts its own launches on the device, replays included, while the
wrappers' host counts tick only where they launch or record.

The file imports neither jax nor the reference package, so it runs on the
machine with the card (`tests/conftest.py` imports jax, hence
`--noconftest`):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_graphs.py
"""
import dataclasses

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro_torch.core import topology as T
from repro_torch.core import traffic
from repro_torch.core.engine import sweep as SW
from repro_torch.core.engine.sweep import BatchedSweep
from repro_torch.core.simulator import SimConfig, Simulator
from repro_torch.kernels.netsim import cycle_core, grant
from repro_torch.kernels.netsim import ops as netsim_ops

pytestmark = pytest.mark.cuda

SMALL = dict(a=2, b=2, m=2, n=4, noc=2, g=3)
CYCLES = dict(warmup=62, measure=118)     # 62 and 61 fall inside K = 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def net():
    return T.build_switchless(T.SwitchlessParams(**SMALL), "graphs")


def _fault_rows(net):
    glob = np.where(net.ch_type == T.GLOBAL)[0]
    cold = T.FaultSet(dead_ch=tuple(int(c) for c in glob[:2]))
    return [T.FaultSet(), cold,
            T.FaultSchedule(((0, T.FaultSet()), (61, cold)))]


def _rows(grid):
    return [dataclasses.asdict(r) for r in grid.flat()]


def _cfg(impl):
    return SimConfig(**CYCLES, vc_mode="updown", reap_age=20,
                     step_impl=impl)


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("impl", ["jnp", "fused", "compact"])
def test_captured_equals_eager(cuda, net, impl, k, monkeypatch):
    rows = _fault_rows(net)
    eager = Simulator(net, _cfg(impl), traffic.uniform(net), device=cuda,
                      loop="eager").sweep_faults(1.2, rows, (0, 1))
    monkeypatch.setenv("REPRO_SUPERSTEP", str(k))
    sim = Simulator(net, _cfg(impl), traffic.uniform(net), device=cuda)
    assert sim.loop == "graph"
    got = sim.sweep_faults(1.2, rows, (0, 1))
    assert got.superstep == k
    assert _rows(got) == _rows(eager)


def test_second_sweep_captures_nothing(cuda, net, monkeypatch):
    monkeypatch.setenv("REPRO_SUPERSTEP", "2")
    sim = Simulator(net, _cfg("fused"), traffic.uniform(net), device=cuda)
    before = SW.compile_counter()
    first = sim.sweep_grid([0.3, 1.2], seeds=(0, 1))
    assert SW.compile_counter() == before + 1
    assert first.compile_count == 1 and first.compile_s > 0
    second = sim.sweep_grid([0.3, 1.2], seeds=(0, 1))
    assert SW.compile_counter() == before + 1
    assert second.compile_count == 0 and second.compile_s == 0.0
    assert _rows(second) == _rows(first)
    SW.clear_aot_cache()
    sim.sweep_grid([0.3, 1.2], seeds=(0, 1))
    assert SW.compile_counter() == before + 2


def test_escalation_recaptures_once(cuda, net):
    sim = Simulator(net, SimConfig(**CYCLES, step_impl="compact"),
                    traffic.uniform(net), device=cuda)
    lanes = [(r, s, None) for r in (0.3, 1.2) for s in (0, 1)]
    eager = Simulator(net, SimConfig(**CYCLES, step_impl="compact"),
                      traffic.uniform(net), device=cuda, loop="eager")
    want = eager._batched.run_lanes_async(lanes, capacity=40).finish()
    before = SW.compile_counter()
    run = sim._batched.run_lanes_async(lanes, capacity=40).finish()
    assert run.escalations >= 1
    assert SW.compile_counter() == before + 1 + run.escalations
    assert run.compile_count == 1
    assert run.escalation_compiles == run.escalations
    assert run.compact_capacity == want.compact_capacity
    assert [dataclasses.asdict(r) for r in run.results] == \
        [dataclasses.asdict(r) for r in want.results]
    # a later sweep starts at the escalated rung: its graph is cached
    again = sim._batched.run_lanes(lanes)
    assert again.escalations == 0 and again.compile_count == 0
    assert SW.compile_counter() == before + 1 + run.escalations


def _coop_grants():
    return netsim_ops.device_launches()["grant"]["coop"]


def test_launch_counts_follow_replays(cuda, net, monkeypatch):
    """The kernel counts what the card runs, on the device: every cycle of
    the run plus the capture's warm-up superstep (the capture itself runs
    nothing).  The wrapper's host count ticks at the warm-up and at each
    launch the capture records, never at a replay."""
    monkeypatch.setenv("REPRO_SUPERSTEP", "4")
    sim = Simulator(net, _cfg("jnp"), traffic.uniform(net), device=cuda)
    n0, d0 = grant.launches, _coop_grants()
    grid = sim.sweep_grid([0.3, 1.2], seeds=(0, 1))
    cycles = CYCLES["warmup"] + CYCLES["measure"]
    assert grid.compile_count == 1
    assert _coop_grants() - d0 == cycles + 4
    assert grant.launches - n0 == 4 + 4
    n1, d1 = grant.launches, _coop_grants()
    sim.sweep_grid([0.3, 1.2], seeds=(0, 1))
    assert _coop_grants() - d1 == cycles
    assert grant.launches == n1


def test_sequential_form_and_run_replay_graphs(cuda, net):
    """`Simulator.run` captures one graph and equals the eager loop."""
    cfg = _cfg("compact")
    sim = Simulator(net, cfg, traffic.uniform(net), device=cuda)
    before = SW.compile_counter()
    got = sim.run(0.8, seed=3)
    assert SW.compile_counter() == before + 1
    want = Simulator(net, cfg, traffic.uniform(net), device=cuda,
                     loop="eager").run(0.8, seed=3)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def _random_rows(gen, B, N, E):
    out = torch.randint(-1, E, (B, N), generator=gen, dtype=torch.int32)
    itime = torch.randint(0, 50, (B, N), generator=gen, dtype=torch.int32)
    ok = torch.rand((B, N), generator=gen) < 0.7
    ch_ok = torch.rand((B, E), generator=gen) < 0.9
    return out, itime, ok, ch_ok


@pytest.mark.parametrize("wrapper", ["cycle_core", "grant"])
def test_coop_kernel_replays_equal_eager_calls(cuda, wrapper):
    """A graph holding one coop launch, replayed n times on fresh inputs,
    equals n eager calls on the same inputs; its scratch's call count
    advances once per replay (and once for the warm-up)."""
    B, N, E, n = 3, 1001, 257, 6
    gen = torch.Generator().manual_seed(0)
    batches = [[x.to(cuda) for x in _random_rows(gen, B, N, E)]
               for _ in range(n)]
    static = [x.clone() for x in batches[0]]

    def call(out, itime, ok, ch_ok):
        if wrapper == "cycle_core":
            return cycle_core(out, itime, ok, ch_ok, r2=1 << 10,
                              kernel="coop")
        zeros = torch.zeros_like(out)
        return grant(out, itime, ok, zeros, out == 0,
                     (~ch_ok).to(torch.int32), torch.ones_like(ch_ok),
                     buf_pkts=8, kernel="coop")

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        call(*static)                         # warm-up: the scratch
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        outs = call(*static)
    scratch = netsim_ops._SCRATCH[(static[0].device, stream.cuda_stream, B,
                                   E)]
    calls0 = int(scratch[-1])
    for i, batch in enumerate(batches):
        for dst, src in zip(static, batch):
            dst.copy_(src)
        graph.replay()
        want = call(*batch)
        for g, w in zip(outs, want):
            assert torch.equal(g, w), (i, wrapper)
    torch.cuda.synchronize()
    assert int(scratch[-1]) == calls0 + n


@pytest.mark.parametrize("kernel", netsim_ops.KERNELS)
@pytest.mark.parametrize("wrapper", ["cycle_core", "grant"])
def test_device_counts_every_replay(cuda, wrapper, kernel):
    """A graph holding one launch, replayed n times: the kernel's device
    count advances once for the warm-up and once per replay; the wrapper's
    host count once for the warm-up and once for the recording."""
    B, N, E, n = 2, 777, 129, 5
    rows = [x.to(cuda) for x in _random_rows(torch.Generator().manual_seed(1),
                                             B, N, E)]
    fn = cycle_core if wrapper == "cycle_core" else grant

    def call():
        out, itime, ok, ch_ok = rows
        if wrapper == "cycle_core":
            return cycle_core(out, itime, ok, ch_ok, r2=1 << 10,
                              kernel=kernel)
        return grant(out, itime, ok, torch.zeros_like(out), out == 0,
                     (~ch_ok).to(torch.int32), torch.ones_like(ch_ok),
                     buf_pkts=8, kernel=kernel)

    d0 = netsim_ops.device_launches()[wrapper][kernel]
    h0 = fn.launches_by_kernel[kernel]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        call()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        call()
    for _ in range(n):
        graph.replay()
    assert netsim_ops.device_launches()[wrapper][kernel] == d0 + 1 + n
    assert fn.launches_by_kernel[kernel] == h0 + 2


def _drain(session):
    while not session.done():
        session.advance()
    return [dataclasses.asdict(r) for r in session.finish().results]


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("impl", ["jnp", "fused", "compact"])
def test_session_windows_equal_eager_loop(cuda, net, impl, k, monkeypatch):
    """A session's windows replayed under capture (window 48 over 180
    cycles: the last window is 36, and at K = 4 the warm onset 61 and the
    reset 62 fall inside supersteps) equal the eager loop's session and
    its one-shot run."""
    lanes = [(1.2, s, f) for f in _fault_rows(net) for s in (0, 1)]
    eager = BatchedSweep(net, _cfg(impl), traffic.uniform(net),
                         device=cuda, loop="eager")
    want = [dataclasses.asdict(r) for r in eager.run_lanes(lanes).results]
    assert _drain(eager.start_lanes(lanes, window=48)) == want
    monkeypatch.setenv("REPRO_SUPERSTEP", str(k))
    sw = BatchedSweep(net, _cfg(impl), traffic.uniform(net), device=cuda)
    before = SW.compile_counter()
    ses = sw.start_lanes(lanes, window=48, pad_to=8)
    assert ses.superstep == k and ses.compile_count == 1
    assert SW.compile_counter() == before + 1
    assert _drain(ses) == want
    assert SW.compile_counter() == before + 1


def test_interleaved_sessions_share_one_graph(cuda, net):
    """Two sessions of one signature, advanced in turns one window each,
    replay one captured graph and each equal their own one-shot run; an
    export after window 2 restores into a third that equals it too."""
    sw = BatchedSweep(net, _cfg("fused"), traffic.uniform(net), device=cuda)
    a = [(0.3, 0, None), (1.2, 1, None)]
    b = [(0.8, 5, _fault_rows(net)[1]), (1.5, 6, None)]
    want = [[dataclasses.asdict(r) for r in sw.run_lanes(x).results]
            for x in (a, b)]
    before = SW.compile_counter()
    sa, sb = (sw.start_lanes(x, window=40, pad_to=4, force_stack=True)
              for x in (a, b))
    assert SW.compile_counter() == before + 1
    assert (sa.compile_count, sb.compile_count) == (1, 0)
    snap = None
    while not (sa.done() and sb.done()):
        sa.advance()
        sb.advance()
        if sb.cycle == 80:
            snap = sb.export()
    assert SW.compile_counter() == before + 1
    assert _drain(sa) == want[0] and _drain(sb) == want[1]
    sc = sw.start_lanes(b, window=40, pad_to=4, force_stack=True,
                        restore=snap)
    assert sc.cycle == 80 and _drain(sc) == want[1]


def test_capture_failure_raises(cuda, net):
    """A step that synchronises with the host cannot be captured: the
    sweep raises, caches nothing and runs nothing eagerly instead.  (Last
    in the file: a failed capture must not leave the card unusable, and
    the test after it would show that.)"""
    sim = Simulator(net, _cfg("jnp"), traffic.uniform(net), device=cuda)
    step = sim._batched.step

    def syncing(state, t_key_rate_fl):
        state, aux = step(state, t_key_rate_fl)
        if int(state.b_count.sum()) < 0:        # a host synchronisation
            raise AssertionError("unreachable")
        return state, aux

    sim._batched.step = syncing
    before, n0, d0 = SW.compile_counter(), grant.launches, _coop_grants()
    with pytest.raises(RuntimeError):
        sim.sweep_grid([0.3], seeds=(0,))
    assert SW.compile_counter() == before
    assert _coop_grants() == d0 + 1             # the warm-up cycle only
    assert grant.launches == n0 + 2             # and the one recorded


def test_card_usable_after_a_failed_capture(cuda, net):
    sim = Simulator(net, _cfg("fused"), traffic.uniform(net), device=cuda)
    eager = Simulator(net, _cfg("fused"), traffic.uniform(net), device=cuda,
                      loop="eager")
    assert _rows(sim.sweep_grid([0.3], seeds=(0,))) == \
        _rows(eager.sweep_grid([0.3], seeds=(0,)))
