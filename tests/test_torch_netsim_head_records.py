"""The fused step's record gathers, `netsim.ops.head_records_dense` and
`head_records_picked`: the plain versions against the `take` /
`lane_take` expressions the step used and a loop over the records, the
launch counts' layout, and the step's calls, on the CPU; on the card
(marker `cuda`) the CUDA kernels bit for bit against the plain versions
at the benchmark networks' shapes, inside a captured CUDA graph, and
their refusals.

The file imports neither jax nor the reference package, so its card
tests run on the machine with the card:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_netsim_head_records.py
"""
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro_torch import random as jr
from repro_torch.core import topology as PT
from repro_torch.core import traffic as PTR
from repro_torch.core.engine import build_lane, make_state, make_step
from repro_torch.core.engine.state import with_sink_row
from repro_torch.core.routing import share_lanes
from repro_torch.core.simulator import SimConfig
from repro_torch.kernels.netsim import (head_records_dense,
                                       head_records_dense_ref,
                                       head_records_picked,
                                       head_records_picked_ref)
from repro_torch.kernels.netsim import ops as netsim_ops
from repro_torch.tensors import lane_take, take

torch.set_num_threads(1)

F = netsim_ops.RECORD_FIELDS
I32 = np.iinfo(np.int32)


def _store(rng, B, E, NV, S, sink=True):
    """A `make_state`-like ``b_pkt`` view [B, E, NV, S, F] of random
    records with a spare channel row behind it (`sink`), that row filled
    with a value no gather may return."""
    full = rng.integers(I32.min, I32.max, (B, E + 1, NV, S, F),
                        dtype=np.int64).astype(np.int32)
    full[:, E] = -7
    store = torch.as_tensor(full)
    return store.narrow(1, 0, E) if sink else store[:, :E].contiguous()


def _b_head(rng, B, E, NV, S):
    """Head slots with slot 0 and slot S - 1 each present."""
    b_head = rng.integers(0, S, (B, E, NV)).astype(np.int32)
    b_head[:, 0, 0], b_head[:, -1, -1] = 0, S - 1
    return torch.as_tensor(b_head)


def _loop_dense(store, b_head, rows):
    s, h = store.numpy(), b_head.numpy()
    B, _, NV = s.shape[:3]
    out = np.empty((B, rows * NV, F), np.int32)
    for b in range(B):
        for e in range(rows):
            for v in range(NV):
                out[b, e * NV + v] = s[b, e, v, h[b, e, v]]
    return out


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("NV", [4, 8])
@pytest.mark.parametrize("sink", [True, False])
def test_dense_plain_version_is_the_steps_take(B, NV, sink):
    """Every buffer head of the requesting channels, as the step's `take`
    over the store with its spare row gathered it and as a loop over the
    records: heads at slot 0 and S - 1, and heads of empty buffers (whose
    stale records are gathered too: the gather reads no count)."""
    rng = np.random.default_rng(10 * B + NV)
    E, ER, S = 7, 5, 8
    b_pkt = _store(rng, B, E, NV, S, sink)
    b_head = _b_head(rng, B, E, NV, S)
    store = with_sink_row(b_pkt) if sink else b_pkt
    got = head_records_dense(store, b_head, ER)
    lane3 = torch.arange(B).view(B, 1, 1)
    e_idx = torch.arange(ER).view(1, ER, 1)
    v_idx = torch.arange(NV).view(1, 1, NV)
    step_take = take(store, lane3, e_idx, v_idx, b_head[:, :ER],
                     clamp=False).reshape(B, ER * NV, -1)
    assert got.shape == (B, ER * NV, F) and got.dtype == torch.int32
    assert torch.equal(got, step_take)
    assert torch.equal(got, head_records_dense_ref(store, b_head, ER))
    assert (got.numpy() == _loop_dense(b_pkt, b_head, ER)).all()
    assert not (got == -7).all(-1).any(), "read the spare row"


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("shared", [False, True])
def test_picked_plain_version_is_the_steps_lane_take(B, shared):
    """One record a channel at a picked row, `lane_take`'s rule: 0, R - 1,
    rows past R - 1 clamped, negative rows wrapped once and then clamped;
    a head table shared by every lane (a stride-0 view) too."""
    rng = np.random.default_rng(B)
    R = 11
    head = torch.as_tensor(rng.integers(I32.min, I32.max, (B, R, F),
                                        dtype=np.int64).astype(np.int32))
    if shared:
        head = head[:1].expand(B, R, F)
    idx = torch.as_tensor(np.array(
        [[0, R - 1, R, R + 5, -1, -R, -R - 3, 4]] * B, np.int32))
    got = head_records_picked(head, idx)
    assert got.shape == (B, idx.shape[1], F)
    assert torch.equal(got, lane_take(head, idx))
    assert torch.equal(got, head_records_picked_ref(head, idx))
    rows = [0, R - 1, R - 1, R - 1, R - 1, 0, 0, 4]
    for b in range(B):
        assert torch.equal(got[b], head[b, rows])


def test_cpu_calls_count_no_launch():
    """The CPU runs the plain versions and counts no launch, as the other
    netsim wrappers do."""
    rng = np.random.default_rng(0)
    store, b_head = _store(rng, 2, 4, 4, 8), _b_head(rng, 2, 4, 4, 8)
    counts = netsim_ops.head_records
    before = (counts.launches, dict(counts.launches_by_kernel))
    head = head_records_dense(with_sink_row(store), b_head, 3)
    head_records_picked(head, torch.zeros((2, 4), dtype=torch.int32))
    assert (counts.launches, counts.launches_by_kernel) == before
    assert set(counts.launches_by_kernel) == {"dense", "picked"}


def test_launch_counts_have_a_slot_for_each_form(monkeypatch):
    """`device_launches` lists `head_records` by form, and each (wrapper,
    kernel) adds to a slot of its own in the device's count table: 2 + 2
    arbitration kernels, 2 gathers, 5 draws and the key chain."""
    dev = torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(netsim_ops, "_DEVICE_LAUNCHES", {})
    assert netsim_ops.device_launches(dev)["head_records"] == {
        "dense": 0, "picked": 0}
    slots = {(w, k): netsim_ops._launch_slot(dev, w, k)
             for w in netsim_ops.WRAPPERS
             for k in netsim_ops.WRAPPER_KERNELS[w]}
    table = netsim_ops._DEVICE_LAUNCHES[dev]
    assert len(set(slots.values())) == len(slots) == 12
    for n, ((w, k), addr) in enumerate(slots.items()):
        table.view(-1)[(addr - table.data_ptr()) // 8] = n + 1
    got = netsim_ops.device_launches(dev)
    assert [got[w][k] for w, k in slots] == list(range(1, 13))


@pytest.mark.parametrize("impl,dense,picked", [("fused", 1, 1),
                                               ("compact", 0, 0)])
def test_fused_step_gathers_through_head_records(monkeypatch, impl, dense,
                                                 picked):
    """The dense fused step calls each gather once a cycle, the buffer
    heads and the winners' records; the compact step keeps its own
    gathers."""
    calls = []
    for form, real in (("dense", head_records_dense),
                       ("picked", head_records_picked)):
        def counted(*args, form=form, real=real):
            calls.append(form)
            return real(*args)
        monkeypatch.setattr(netsim_ops, f"head_records_{form}", counted)
    net = PT.build_switchless(PT.SwitchlessParams(a=1, b=1, m=2, n=6, noc=2,
                                                  g=3), "head-records")
    cfg = SimConfig(warmup=2, measure=6, step_impl=impl)
    step, consts = make_step(net, cfg, PTR.uniform(net), device="cpu")
    fl = share_lanes(build_lane(net, cfg, None, device="cpu"), 2)
    state = make_state(net, cfg, consts["NV"], batch=(2,), device="cpu")
    rate = torch.tensor([0.5, 0.9])
    cycles = 4
    for t in range(cycles):
        key = torch.stack([jr.PRNGKey(t), jr.PRNGKey(t + 9)])
        state, _ = step(state, (t, key, rate, fl))
    assert calls.count("dense") == dense * cycles
    assert calls.count("picked") == picked * cycles
    if impl == "fused":
        assert int(state.stats.generated.sum()) > 0


def test_record_checks_refuse_what_the_kernel_cannot_read():
    """The host's checks before a launch: 32-byte int32 records, fields
    contiguous, strides a multiple of 4 fields, the base 16-byte
    aligned."""
    ok = torch.zeros((2, 6, F), dtype=torch.int32)
    netsim_ops._record_table("head", ok, 3)
    bad = {
        "seven fields": torch.zeros((2, 6, 7), dtype=torch.int32),
        "int64": torch.zeros((2, 6, F), dtype=torch.int64),
        "strided fields": torch.zeros((2, 6, 2 * F),
                                      dtype=torch.int32)[..., ::2],
        "row stride 9": torch.zeros((2, 6, 9), dtype=torch.int32)[..., :F],
        "base off 16 bytes": torch.zeros(2 * 6 * F + 1, dtype=torch.int32)[
            1:].view(2, 6, F),
        "four dims": torch.zeros((2, 6, 1, F), dtype=torch.int32),
    }
    for what, x in bad.items():
        with pytest.raises(ValueError, match="head_records"):
            netsim_ops._record_table("head", x, 3)
            pytest.fail(what)


# ---- on the card -------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


# (B, E, E_req, NV, S): the benchmark's radix-16 switch-less and
# switch-based networks at 24 lanes, and a ragged small one
CARD_SHAPES = {"sl16": (24, 30_176, 24_928, 8, 8),
               "df16": (24, 6_560, 5_248, 8, 8),
               "small": (3, 37, 29, 4, 5)}


def _card_inputs(device, B, E, ER, NV, S, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    full = torch.randint(I32.min, I32.max, (B, E + 1, NV, S, F),
                         dtype=torch.int32, device=device, generator=g)
    b_pkt = full.narrow(1, 0, E)
    b_head = torch.randint(0, S, (B, E, NV), dtype=torch.int32,
                           device=device, generator=g)
    b_head[:, 0, 0], b_head[:, ER - 1, NV - 1] = 0, S - 1
    return b_pkt, b_head, g


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(CARD_SHAPES))
def test_kernel_matches_plain_version(cuda, shape):
    """Both forms bit for bit against the plain versions on the card, one
    launch each counted by the wrapper and on the device; the picked
    index at 0, R - 1, past R - 1 and negative."""
    B, E, ER, NV, S = CARD_SHAPES[shape]
    b_pkt, b_head, g = _card_inputs(cuda, B, E, ER, NV, S)
    store = with_sink_row(b_pkt)
    R = ER * NV
    idx = torch.randint(-R - 3, R + 3, (B, E), dtype=torch.int32,
                        device=cuda, generator=g)
    idx[:, :4] = torch.tensor([0, R - 1, R, -1], dtype=torch.int32,
                              device=cuda)
    d0 = netsim_ops.device_launches()["head_records"]
    counts = netsim_ops.head_records
    h0 = dict(counts.launches_by_kernel)
    head = head_records_dense(store, b_head, ER)
    picked = head_records_picked(head, idx)
    torch.cuda.synchronize()
    d1 = netsim_ops.device_launches()["head_records"]
    assert {k: d1[k] - d0[k] for k in d1} == {"dense": 1, "picked": 1}
    assert {k: counts.launches_by_kernel[k] - h0[k]
            for k in h0} == {"dense": 1, "picked": 1}
    assert torch.equal(head, head_records_dense_ref(store, b_head, ER))
    assert torch.equal(picked, head_records_picked_ref(head, idx))


@pytest.mark.cuda
def test_kernel_in_a_cuda_graph_equals_eager(cuda):
    """Both forms captured in one CUDA graph and replayed three times over
    new head slots and picks: each replay equals the eager call, and the
    kernels count every replay on the device."""
    B, E, ER, NV, S = CARD_SHAPES["df16"]
    b_pkt, b_head, g = _card_inputs(cuda, B, E, ER, NV, S, seed=1)
    store = with_sink_row(b_pkt)
    idx = torch.zeros((B, E), dtype=torch.int32, device=cuda)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        head_records_picked(head_records_dense(store, b_head, ER), idx)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        head = head_records_dense(store, b_head, ER)
        picked = head_records_picked(head, idx)
    d0 = netsim_ops.device_launches()["head_records"]
    for rep in range(3):
        b_head.copy_(torch.randint(0, S, b_head.shape, dtype=torch.int32,
                                   device=cuda, generator=g))
        idx.copy_(torch.randint(-5, ER * NV + 5, idx.shape,
                                dtype=torch.int32, device=cuda, generator=g))
        graph.replay()
        want = head_records_dense(store, b_head, ER)
        assert torch.equal(head, want), f"replay {rep}"
        assert torch.equal(picked, head_records_picked(want, idx)), \
            f"replay {rep}"
    d1 = netsim_ops.device_launches()["head_records"]
    # three replays and three eager calls a form
    assert {k: d1[k] - d0[k] for k in d1} == {"dense": 6, "picked": 6}


@pytest.mark.cuda
def test_kernel_refuses_records_it_cannot_read(cuda):
    """Records that are not 32 contiguous bytes, a base off 16 bytes, an
    int64 index: ValueError before any launch."""
    B, E, ER, NV, S = CARD_SHAPES["small"]
    b_pkt, b_head, _ = _card_inputs(cuda, B, E, ER, NV, S)
    store = with_sink_row(b_pkt)
    seven = torch.zeros((B, E + 1, NV, S, 7), dtype=torch.int32,
                        device=cuda)
    flat = torch.zeros(store.numel() + 1, dtype=torch.int32, device=cuda)
    shifted = flat[1:].view(store.shape)
    head = head_records_dense(store, b_head, ER)
    before = netsim_ops.device_launches()["head_records"]
    with pytest.raises(ValueError, match="32 bytes"):
        head_records_dense(seven, b_head, ER)
    with pytest.raises(ValueError, match="16-byte"):
        head_records_dense(shifted, b_head, ER)
    R = ER * NV - 1
    with pytest.raises(ValueError, match="16-byte"):
        head_records_picked(head.view(-1)[2:2 + B * R * F].view(B, R, F),
                     torch.zeros((B, E), dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="int32"):
        head_records_picked(head, torch.zeros((B, E), dtype=torch.int64,
                                       device=cuda))
    with pytest.raises(ValueError, match="do not fit"):
        head_records_dense(store, b_head, E + 1)
    assert netsim_ops.device_launches()["head_records"] == before
