"""The PRNG's Threefry kernel, `netsim.ops.threefry_*`, behind every draw
of `repro_torch.random` and the sweep's per-cycle key chain
(`engine.step.key_chain`): on the CPU, that a CPU key runs the plain
versions and never loads the kernel library, that the wrappers refuse a
key (or a chain's cycle count) they cannot read, the launch counts'
layout, that each draw of a cycle step is one wrapper call (3 a cycle
under `min`, 4 under UGAL) and a dispatch's chain one; on the card
(marker `cuda`) every form bit for bit against the plain versions on the
CPU, at the shapes, spans and keys of its callers (24 lanes of the
benchmark's 5,248 terminals and 1,500 cycles, strided views of a
`split`), one launch a draw or chain, inside a captured CUDA graph, and a
session's windows chaining their keys on the card.  The plain versions
are held to `jax.random` in `tests/test_torch_random.py`, at the same
shapes and spans.

The file imports neither jax nor the reference package, so its card
tests run on the machine with the card:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_netsim_threefry.py
"""
import dataclasses

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro_torch import random as jr
from repro_torch import spans
from repro_torch.core.engine import build_lane, make_state, make_step
from repro_torch.core.engine.step import key_chain, superstep_body
from repro_torch.core.engine.sweep import BatchedSweep
from repro_torch.core.routing import share_lanes
from repro_torch.core.simulator import SimConfig
from repro_torch.exp.spec import TopologySpec, TrafficSpec
from repro_torch.kernels.netsim import ops as netsim_ops
from repro_torch.kernels.netsim import ref as netsim_ref

torch.set_num_threads(1)

# the benchmark's switch-less cell: 24 lanes of 5,248 terminals
LANES, TERMS = 24, 5_248
SHAPES = [(), (7,), (TERMS,), (3, 5)]
# the callers' spans (misrouting over 41 W-groups, uniform traffic over
# T - 1 others, a power of two) and the edges: the widest span from 0, a
# negative minval, the whole int32 range, an empty range
SPANS = [(0, 41), (0, 128), (0, TERMS - 1), (0, 2**31 - 1), (-3, 100_003),
         (-2**31, 2**31 - 1), (5, 5)]
DRAWS = {
    "bits": lambda k, shape: jr.random_bits(k, shape),
    "uniform": lambda k, shape: jr.uniform(k, shape),
    "bernoulli": lambda k, shape: jr.bernoulli(k, 0.3, shape),
}


def _keys(n=LANES, seed0=2**31 + 17):
    """`n` lane keys from large seeds, as the benchmark's lanes draw."""
    return torch.stack([jr.PRNGKey(seed0 + 7919 * i) for i in range(n)])


def _every_draw(key):
    """Each public draw once, on `key` and on strided views of its split."""
    ks = jr.split(key, 3)
    return [ks, jr.random_bits(ks[..., 0, :], (5,)),
            jr.uniform(ks[..., 1, :], (3, 5)),
            jr.randint(ks[..., 2, :], (9,), -3, 41),
            jr.bernoulli(key, 0.5, (9,))]


# the forms `_every_draw` launches once each: all but the key chain
DRAW_FORMS = tuple(f for f in netsim_ops.THREEFRY_FORMS if f != "chain")


def test_a_cpu_key_never_loads_the_library(monkeypatch):
    """Every draw of a CPU key (one key, lanes, strided views) runs the
    plain versions: the kernel library is never asked for."""
    def refuse(*a, **k):
        raise AssertionError("a CPU draw asked for the kernel library")
    monkeypatch.setattr(netsim_ops, "library", refuse)
    monkeypatch.setattr(netsim_ops, "_BOUND", {})
    for key in (jr.PRNGKey(3), _keys(4)):
        got = _every_draw(key)
        ks = netsim_ref.threefry_split_ref(key, 3)
        want = [ks, netsim_ref.threefry_bits_ref(ks[..., 0, :], (5,)),
                netsim_ref.threefry_uniform_ref(ks[..., 1, :], (3, 5)),
                netsim_ref.threefry_randint_ref(ks[..., 2, :], (9,), -3, 41),
                netsim_ref.threefry_bernoulli_ref(key, 0.5, (9,))]
        got += list(key_chain(key, 3))
        want += list(netsim_ref.threefry_chain_ref(key, 3))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)


BAD_KEYS = {
    "int32": lambda: jr.PRNGKey(1).to(torch.int32),
    "float": lambda: jr.PRNGKey(1).to(torch.float32),
    "three words": lambda: torch.zeros(3, dtype=torch.int64),
    "a scalar": lambda: torch.zeros((), dtype=torch.int64),
    "meta device": lambda: torch.zeros(2, dtype=torch.int64, device="meta"),
}
WRAPPER_CALLS = {
    "split": lambda k: netsim_ops.threefry_split(k, 3),
    "bits": lambda k: netsim_ops.threefry_bits(k, (4,)),
    "uniform": lambda k: netsim_ops.threefry_uniform(k, (4,)),
    "randint": lambda k: netsim_ops.threefry_randint(k, (4,), 0, 9),
    "bernoulli": lambda k: netsim_ops.threefry_bernoulli(k, 0.5, (4,)),
    "chain": lambda k: netsim_ops.threefry_chain(k, 3),
}


@pytest.mark.parametrize("form", list(WRAPPER_CALLS))
@pytest.mark.parametrize("bad", list(BAD_KEYS))
def test_wrappers_refuse_a_key_they_cannot_read(monkeypatch, form, bad):
    """A key of another dtype, another last dimension or on a device the
    port does not run on: ValueError, before the library is asked for."""
    monkeypatch.setattr(netsim_ops, "library", lambda *a, **k: 1 / 0)
    monkeypatch.setattr(netsim_ops, "_BOUND", {})
    with pytest.raises(ValueError, match="threefry"):
        WRAPPER_CALLS[form](BAD_KEYS[bad]())


@pytest.mark.parametrize("cycles", [-1, -1500])
def test_chain_refuses_a_negative_cycle_count(monkeypatch, cycles):
    """A chain of fewer than 0 cycles: ValueError on every device, before
    the key is read or the library asked for."""
    monkeypatch.setattr(netsim_ops, "library", lambda *a, **k: 1 / 0)
    monkeypatch.setattr(netsim_ops, "_BOUND", {})
    monkeypatch.setattr(netsim_ops, "_threefry_key",
                        lambda key: torch.device("cuda"))
    with pytest.raises(ValueError, match="cycle count"):
        netsim_ops.threefry_chain(_keys(2), cycles)


@pytest.mark.parametrize("lo,hi", [(0, 2**31), (-2**31 - 1, 0)])
def test_randint_refuses_bounds_outside_int32(lo, hi):
    with pytest.raises(ValueError, match="int32"):
        jr.randint(jr.PRNGKey(0), (4,), lo, hi)


def test_launch_count_layout():
    """`threefry` is a wrapper with one device count a form, zero on a
    device that has launched nothing, and host counts alike."""
    assert netsim_ops.WRAPPERS[-1] == "threefry"
    assert netsim_ops.WRAPPER_KERNELS["threefry"] == (
        "split", "bits", "uniform", "randint", "bernoulli", "chain")
    counts = netsim_ops.device_launches(torch.device("cuda", 99))
    assert counts["threefry"] == dict.fromkeys(
        netsim_ops.THREEFRY_FORMS, 0)
    assert set(netsim_ops.threefry.launches_by_kernel) == set(
        netsim_ops.THREEFRY_FORMS)


def _step_draws(monkeypatch, route_mode, pattern, step_impl):
    """The wrapper's forms one cycle of `step_impl` draws, in order, with
    the wrappers sent down their CUDA branch (each draw computed by the
    plain version in place of the launch)."""
    forms = []

    def draw(form, key, shape, out_shape, dtype, span=1, mult=0, minval=0,
             p=0.0):
        forms.append(form)
        return {"split": lambda: netsim_ref.threefry_split_ref(
                    key, shape[0]),
                "bits": lambda: netsim_ref.threefry_bits_ref(key, shape),
                "uniform": lambda: netsim_ref.threefry_uniform_ref(
                    key, shape),
                "randint": lambda: netsim_ref.threefry_randint_ref(
                    key, shape, minval, minval + span),
                "bernoulli": lambda: netsim_ref.threefry_bernoulli_ref(
                    key, p, shape)}[form]()

    net = TopologySpec.switchless(a=2, b=2, m=2, n=4, noc=2, g=3).build()
    cfg = SimConfig(warmup=4, measure=4, route_mode=route_mode,
                    step_impl=step_impl)
    step, consts = make_step(net, cfg, TrafficSpec(pattern).resolve(net),
                             device="cpu")
    fl = share_lanes(build_lane(net, cfg, None, device="cpu"), 2)
    state = make_state(net, cfg, consts["NV"], batch=(2,), device="cpu")
    subs = netsim_ref.threefry_split_ref(_keys(2), 2)[None, :, 0]
    body = superstep_body(step, 1)
    args = (torch.zeros((), dtype=torch.int32), subs,
            torch.full((2,), 0.5), fl, torch.full((), 4, dtype=torch.int32))
    want = body(state, *args)
    monkeypatch.setattr(netsim_ops, "_threefry_key",
                        lambda key: torch.device("cuda"))
    monkeypatch.setattr(netsim_ops, "_draw", draw)
    got = body(make_state(net, cfg, consts["NV"], batch=(2,),
                          device="cpu"), *args)
    assert torch.equal(got.s_pkt, want.s_pkt)
    assert torch.equal(got.stats.generated, want.stats.generated)
    return forms


@pytest.mark.parametrize("step_impl", ["jnp", "fused", "compact"])
def test_a_cycle_is_one_launch_a_draw(monkeypatch, step_impl):
    """Uniform traffic under minimal routing draws three times a cycle
    (the split of the cycle's key, the generation coins, the
    destinations), worst-case traffic under UGAL four (and the
    intermediate W-group): each one wrapper call, so one launch on the
    card, with the bits of the plain versions."""
    assert _step_draws(monkeypatch, "min", "uniform", step_impl) == [
        "split", "uniform", "randint"]
    assert _step_draws(monkeypatch, "ugal", "worst_case", step_impl) == [
        "split", "uniform", "randint", "randint"]


def test_key_chain_on_a_cuda_key_is_one_chain_launch(monkeypatch):
    """`step.key_chain` on a key that reports a CUDA device makes exactly
    one `chain` call (the launch, computed here by the plain chain) and no
    draw, inside one `sweep.key_chain` span, with the plain chain's bits."""
    forms = []

    def chain(keys, cycles):
        forms.append("chain")
        return netsim_ref.threefry_chain_ref(keys, cycles)

    def draw(form, *args, **kwargs):
        forms.append(form)
        raise AssertionError(f"the key chain drew a {form}")

    keys = _keys(3)
    want = key_chain(keys, 7)
    monkeypatch.setattr(netsim_ops, "_threefry_key",
                        lambda key: torch.device("cuda"))
    monkeypatch.setattr(netsim_ops, "_chain", chain)
    monkeypatch.setattr(netsim_ops, "_draw", draw)
    before = spans.totals().get("sweep.key_chain", (0, 0.0))[0]
    got = key_chain(keys, 7)
    assert forms == ["chain"]
    assert spans.totals()["sweep.key_chain"][0] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("lanes", [1, LANES])
def test_key_chain_of_no_cycles(lanes):
    """No cycles: the keys themselves and an empty ``[0, B, 2]``."""
    keys = _keys(lanes)
    next_keys, subs = key_chain(keys, 0)
    assert torch.equal(next_keys, keys)
    assert subs.dtype == torch.int64 and subs.shape == (0, lanes, 2)


# ---- on the card -------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("num", [2, 3, 24])
def test_split_on_the_card(cuda, num):
    for key in (jr.PRNGKey(2**31 + 5), _keys()):
        _same(jr.split(key.to(cuda), num), jr.split(key, num))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("form", list(DRAWS))
def test_draw_on_the_card(cuda, form, shape):
    draw = DRAWS[form]
    for key in (jr.PRNGKey(2**31 + 5), _keys()):
        _same(draw(key.to(cuda), shape), draw(key, shape))


@pytest.mark.cuda
@pytest.mark.parametrize("lo,hi", SPANS)
def test_randint_on_the_card(cuda, lo, hi):
    for key in (jr.PRNGKey(2**31 + 5), _keys()):
        _same(jr.randint(key.to(cuda), (TERMS,), lo, hi),
              jr.randint(key, (TERMS,), lo, hi))


@pytest.mark.cuda
def test_strided_keys_are_read_in_place(cuda):
    """The step's subkeys `split(key, 3)[:, i]` are strided views: each
    draw reads them through their strides, as the CPU reads a copy; so
    do keys with two lane dimensions."""
    ks = jr.split(_keys().to(cuda), 3)
    assert not ks[:, 0].is_contiguous()
    for i in range(3):
        want = ks[:, i].cpu().contiguous()
        _same(jr.uniform(ks[:, i], (TERMS,)), jr.uniform(want, (TERMS,)))
        _same(jr.randint(ks[:, i], (TERMS,), 0, TERMS - 1),
              jr.randint(want, (TERMS,), 0, TERMS - 1))
    grid = _keys().reshape(4, 6, 2)
    _same(jr.randint(grid.to(cuda), (5,), 0, 41), jr.randint(grid, (5,), 0,
                                                               41))
    _same(jr.split(grid.to(cuda).transpose(0, 1), 3),
          jr.split(grid.transpose(0, 1), 3))


@pytest.mark.cuda
def test_one_launch_a_draw(cuda):
    """Each public draw is one launch of its form, counted on the host
    and by the kernel on the device; an empty draw launches nothing."""
    key = _keys().to(cuda)
    host = netsim_ops.threefry.launches_by_kernel
    h0 = dict(host)
    d0 = netsim_ops.device_launches()["threefry"]
    _every_draw(key)
    jr.uniform(key, (0,))
    torch.cuda.synchronize()
    d1 = netsim_ops.device_launches()["threefry"]
    want = dict(dict.fromkeys(DRAW_FORMS, 1), chain=0)
    assert {k: d1[k] - d0[k] for k in d1} == want
    assert {k: host[k] - h0[k] for k in host} == want


@pytest.mark.cuda
def test_draws_in_a_cuda_graph_equal_eager(cuda):
    """A cycle's draws captured in one CUDA graph over a static key and
    replayed over three new keys: each replay equals the eager draws,
    and the kernel counts every replay on the device."""
    key = _keys().to(cuda)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        _every_draw(key)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        outs = _every_draw(key)
    d0 = netsim_ops.device_launches()["threefry"]
    for rep in range(3):
        key.copy_(_keys(seed0=rep * 1_000_003).to(cuda))
        graph.replay()
        for got, want in zip(outs, _every_draw(key)):
            assert torch.equal(got, want), f"replay {rep}"
    d1 = netsim_ops.device_launches()["threefry"]
    # three replays and three eager draws a form
    assert {k: d1[k] - d0[k] for k in d1} == dict(
        dict.fromkeys(DRAW_FORMS, 6), chain=0)


# the chain's keys: the benchmark's large seeds, one lane alone, and words
# at 2^32 - 1
CHAIN_KEYS = {
    "24 lanes": lambda: _keys(),
    "one key": lambda: jr.PRNGKey(2**31 + 5),
    "one lane": lambda: _keys(1),
    "top words": lambda: torch.tensor([[2**32 - 1, 2**32 - 1],
                                       [0, 2**32 - 1], [2**32 - 1, 0]]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("cycles", [0, 1, 1_500])
@pytest.mark.parametrize("keys", list(CHAIN_KEYS))
def test_chain_on_the_card(cuda, keys, cycles):
    """The chain of CUDA keys equals the plain chain on the CPU bit for
    bit, the next keys and every subkey, both on the card."""
    key = CHAIN_KEYS[keys]()
    got = key_chain(key.to(cuda), cycles)
    want = key_chain(key, cycles)
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        _same(g, w)


@pytest.mark.cuda
def test_chain_of_strided_keys_on_the_card(cuda):
    """A strided view of a `split` output (and keys with two lane
    dimensions) is read through its strides."""
    ks = jr.split(_keys().to(cuda), 3)[:, 1]
    assert not ks.is_contiguous()
    for key in (ks, ks.reshape(4, 6, 2).transpose(0, 1)):
        for g, w in zip(key_chain(key, 300),
                        key_chain(key.cpu().contiguous(), 300)):
            _same(g, w)


@pytest.mark.cuda
def test_one_launch_a_chain(cuda):
    """A chain of any length is one launch of the form `chain`, counted
    on the host and by the kernel on the device."""
    key = _keys().to(cuda)
    host = netsim_ops.threefry.launches_by_kernel
    h0 = dict(host)
    d0 = netsim_ops.device_launches()["threefry"]
    key_chain(key, 1_500)
    torch.cuda.synchronize()
    d1 = netsim_ops.device_launches()["threefry"]
    want = dict(dict.fromkeys(DRAW_FORMS, 0), chain=1)
    assert {k: d1[k] - d0[k] for k in d1} == want
    assert {k: host[k] - h0[k] for k in host} == want


@pytest.mark.cuda
def test_session_windows_chain_their_keys_on_the_card(cuda):
    """A session of 100-cycle windows draws one chain a window on the card
    and keeps its keys there; it ends on the keys of the whole budget's
    chain and the counters of a one-shot run (one chain); its `export()`
    holds host int64 keys, and a restore from it ends the same."""
    net = TopologySpec.switchless(a=2, b=2, m=2, n=4, noc=2, g=3).build()
    cfg = SimConfig(warmup=100, measure=200, step_impl="fused")
    sw = BatchedSweep(net, cfg, TrafficSpec("uniform").resolve(net),
                      device=cuda)
    lanes = [(r, 2**31 + s, None) for r in (0.4, 1.2) for s in (3, 4)]
    d0 = netsim_ops.device_launches()["threefry"]["chain"]
    want = [dataclasses.asdict(r) for r in sw.run_lanes(lanes).results]
    d1 = netsim_ops.device_launches()["threefry"]["chain"]
    assert d1 - d0 == 1
    keys = torch.stack([jr.PRNGKey(s) for _, s, _ in lanes])
    final = key_chain(keys, 300)[0]
    ses = sw.start_lanes(lanes, window=100)
    snap = None
    while not ses.done():
        ses.advance()
        assert ses.keys.device.type == "cuda"
        if ses.cycle == 100:
            snap = ses.export()
    assert netsim_ops.device_launches()["threefry"]["chain"] - d1 == 3
    _same(ses.keys, final)
    assert [dataclasses.asdict(r) for r in ses.finish().results] == want
    assert snap["keys"].dtype == np.int64 and snap["keys"].shape == (4, 2)
    assert torch.equal(torch.as_tensor(snap["keys"]), key_chain(keys, 100)[0])
    again = sw.start_lanes(lanes, window=100, restore=snap)
    while not again.done():
        again.advance()
    _same(again.keys, final)
    assert [dataclasses.asdict(r) for r in again.finish().results] == want
