"""Parity of the port's topology and routing with the JAX reference.

The port keeps its own copy of `topology.py` (the reference module pulls
jax in through `repro.core`), its own routing tables and route kernels.
Every comparison is exact: every `Network` array and table, every
sampled fault set, every `route_tables` entry, and the route kernels'
(out, vc, meta) over every (cur, dest, mis, meta) combination.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import topology as JT
from repro.core.routing import make_route_fn as jax_route_fn
from repro.core.routing import route_tables as jax_route_tables
from repro_torch.core import topology as PT
from repro_torch.core.routing import make_route_fn, route_tables
from repro_torch.core.routing.vcs import PHASE_BIT

# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

SWITCHLESS = dict(a=2, b=2, m=2, n=4, noc=2, g=3)
DRAGONFLY = dict(t=2, l=4, gl=1, g=5)


def _nets(kind):
    if kind == "switchless":
        return (JT.build_switchless(JT.SwitchlessParams(**SWITCHLESS), "s"),
                PT.build_switchless(PT.SwitchlessParams(**SWITCHLESS), "s"))
    return (JT.build_switch_dragonfly(JT.SwitchDragonflyParams(**DRAGONFLY),
                                      "d"),
            PT.build_switch_dragonfly(PT.SwitchDragonflyParams(**DRAGONFLY),
                                      "d"))


def _faults(mod, net, kind, vc_mode, seed=7):
    rng = np.random.default_rng(seed)
    if kind == "dragonfly" or vc_mode == "baseline":
        return mod.sample_link_faults(net, 0.2, rng, types=(mod.GLOBAL,),
                                      vc_mode=vc_mode)
    return mod.sample_link_faults(net, 0.08, rng, vc_mode=vc_mode)


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and (a == b).all(), what


@pytest.mark.parametrize("kind", ["switchless", "dragonfly"])
def test_network_arrays_and_tables(kind):
    jn, pn = _nets(kind)
    for f in ("num_nodes", "num_terminals", "num_chips", "meta"):
        assert getattr(jn, f) == getattr(pn, f), f
    for f in ("term_node", "term_chip", "ch_src", "ch_dst", "ch_bw",
              "ch_lat", "ch_type", "inject_ch", "eject_ch"):
        _same(getattr(jn, f), getattr(pn, f), f)
    assert sorted(jn.tables) == sorted(pn.tables)
    for k in jn.tables:
        _same(jn.tables[k], pn.tables[k], k)


@pytest.mark.parametrize("paper", ["paper_radix16_switchless",
                                   "paper_radix32_switchless",
                                   "paper_radix16_dragonfly",
                                   "paper_table3_switchless"])
def test_paper_presets(paper):
    assert dataclasses.asdict(getattr(JT, paper)()) \
        == dataclasses.asdict(getattr(PT, paper)())


def test_samplers_same_fault_sets():
    jn, pn = _nets("switchless")
    for seed in (0, 3):
        for name, args in [("sample_link_faults", (0.1,)),
                           ("sample_router_faults", (3,))]:
            a = getattr(JT, name)(jn, *args, np.random.default_rng(seed))
            b = getattr(PT, name)(pn, *args, np.random.default_rng(seed))
            assert (a.dead_ch, a.dead_routers) == (b.dead_ch, b.dead_routers)
        a = JT.sample_cluster_faults(jn, np.random.default_rng(seed))
        b = PT.sample_cluster_faults(pn, np.random.default_rng(seed))
        assert (a.dead_ch, a.dead_routers) == (b.dead_ch, b.dead_routers)
        assert np.array_equal(a.ch_alive(jn), b.ch_alive(pn))
        assert np.array_equal(a.term_alive(jn), b.term_alive(pn))


CASES = [("switchless", "baseline"), ("switchless", "updown"),
         ("switchless", "updown_merged"), ("dragonfly", "baseline")]


@pytest.mark.parametrize("kind,vc_mode", CASES)
@pytest.mark.parametrize("faulted", [False, True])
def test_route_tables(kind, vc_mode, faulted):
    jn, pn = _nets(kind)
    jf = _faults(JT, jn, kind, vc_mode) if faulted else None
    pf = _faults(PT, pn, kind, vc_mode) if faulted else None
    want = jax_route_tables(jn, vc_mode, jf)
    got = route_tables(pn, vc_mode, pf, device="cpu")
    assert sorted(want) == sorted(got)
    for k in want:
        _same(want[k], got[k].numpy(), k)


@pytest.mark.parametrize("kind,vc_mode", CASES)
@pytest.mark.parametrize("faulted", [False, True])
def test_route_kernel_outputs(kind, vc_mode, faulted):
    """(out, vc, meta) over every (cur, dest, mis) and a spread of metas
    (fresh, mid-route, phase bit set, saturated counters)."""
    jn, pn = _nets(kind)
    jf = _faults(JT, jn, kind, vc_mode) if faulted else None
    pf = _faults(PT, pn, kind, vc_mode) if faulted else None
    g = jn.meta["g"]
    metas = np.array([0, 0x09, PHASE_BIT | 0x12, 0x2F, PHASE_BIT | 0x3F])
    cur, dest, mis, meta = (a.reshape(-1).astype(np.int32) for a in np.meshgrid(
        np.arange(jn.num_nodes), np.arange(jn.num_terminals),
        np.arange(-1, g), metas, indexing="ij"))
    want = jax_route_fn(jn, vc_mode, jf)(
        *(jnp.asarray(x) for x in (cur, dest, mis, meta)))
    got = make_route_fn(pn, vc_mode, pf, device="cpu")(
        *(torch.as_tensor(x)[None] for x in (cur, dest, mis, meta)))
    for name, w, p in zip(("out", "vc", "meta"), want, got):
        assert p.dtype == torch.int32, name
        _same(w, p[0].numpy(), name)
