"""The port's deadlock proofs (`repro_torch.core.routing.verify`) against
the reference's (`repro.core.routing.verify`): the same verdicts and the
same channel-dependency-graph edge counts with the same numpy `rng`, over
the three VC schemes x minimal / non-minimal routing x pristine, cold,
warm and repair fault states, plus the switch-based Dragonfly baseline
(as `tests/test_routing.py` and the fault tests run the reference).  The
port's numpy CDG is also held to networkx's on the same paths."""
import networkx as nx
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import routing as R
from repro.core import topology as T
from repro.core.routing import verify as V
from repro_torch.core import routing as PR
from repro_torch.core import topology as PT
from repro_torch.core.routing import verify as PV

# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

SWITCHLESS = dict(a=2, b=2, m=2, n=4, noc=2, g=3)
DRAGONFLY = dict(t=2, l=3, gl=2, g=5)
MODES = ("baseline", "updown", "updown_merged")


@pytest.fixture(scope="module")
def nets():
    return (T.build_switchless(T.SwitchlessParams(**SWITCHLESS)),
            PT.build_switchless(PT.SwitchlessParams(**SWITCHLESS)))


@pytest.fixture(scope="module")
def dnets():
    return (T.build_switch_dragonfly(T.SwitchDragonflyParams(**DRAGONFLY)),
            PT.build_switch_dragonfly(PT.SwitchDragonflyParams(**DRAGONFLY)))


def _faults(top, net, mode, seed, base=None):
    """One package's cold fault set: global links only under the baseline
    scheme (which cannot route around anything else), else links of every
    type; sampled from `seed`, so both packages draw the same set."""
    types = (top.GLOBAL,) if mode == "baseline" else (
        top.MESH, top.LOCAL, top.GLOBAL)
    frac = 0.3 if mode == "baseline" else 0.06
    return top.sample_link_faults(net, frac, np.random.default_rng(seed),
                                  types=types, vc_mode=mode, base=base)


def _both(fn_ref, fn_port):
    """(reference outcome, port outcome): a value, or the error's type."""
    out = []
    for fn in (fn_ref, fn_port):
        try:
            out.append(fn())
        except (AssertionError, RuntimeError) as e:
            out.append(type(e).__name__)
    return out


@pytest.mark.parametrize("nonmin", [False, True])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("state", ["pristine", "cold"])
def test_deadlock_free_equals_reference(nets, mode, nonmin, state):
    net, pnet = nets
    f = pf = None
    if state == "cold":
        f, pf = _faults(T, net, mode, 11), _faults(PT, pnet, mode, 11)
        assert not f.is_empty and f.dead_ch == pf.dead_ch
    want, got = _both(
        lambda: R.assert_deadlock_free(net, mode, nonmin,
                                       np.random.default_rng(7),
                                       n_pairs=1500, faults=f),
        lambda: PR.assert_deadlock_free(pnet, mode, nonmin,
                                        np.random.default_rng(7),
                                        n_pairs=1500, faults=pf,
                                        device="cpu"))
    assert isinstance(want, int) and want > 0
    assert got == want


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ["warm", "repair"])
def test_schedule_deadlock_free_equals_reference(nets, mode, kind):
    """Every epoch's proof and every transition's, edge count for edge
    count: a growing schedule (warm) and one that shrinks back (repair)."""
    net, pnet = nets
    sched = []
    for top, n in ((T, net), (PT, pnet)):
        f1 = _faults(top, n, mode, 13)
        f2 = _faults(top, n, mode, 17, base=f1)
        epochs = ((0, top.FaultSet()), (60, f1), (120, f2))
        if kind == "repair":
            epochs += ((180, f1),)
        sch = top.FaultSchedule(epochs)
        sch.validate(n, mode)
        sched.append(sch)
    want, got = _both(
        lambda: R.assert_schedule_deadlock_free(
            net, mode, True, np.random.default_rng(5), sched[0],
            n_pairs=400),
        lambda: PR.assert_schedule_deadlock_free(
            pnet, mode, True, np.random.default_rng(5), sched[1],
            n_pairs=400, device="cpu"))
    assert isinstance(want, list) and all(e > 0 for e in want)
    assert got == want


def test_transition_safe_equals_reference(nets):
    net, pnet = nets
    f, pf = _faults(T, net, "updown", 3), _faults(PT, pnet, "updown", 3)
    want = V.assert_transition_safe(net, "updown", True,
                                    np.random.default_rng(2), f,
                                    T.FaultSet(), n_pairs=500)
    got = PV.assert_transition_safe(pnet, "updown", True,
                                    np.random.default_rng(2), pf,
                                    PT.FaultSet(), n_pairs=500,
                                    device="cpu")
    assert want > 0 and got == want


@pytest.mark.parametrize("nonmin", [False, True])
def test_dragonfly_deadlock_free_equals_reference(dnets, nonmin):
    net, pnet = dnets
    want = R.assert_deadlock_free(net, "baseline", nonmin,
                                  np.random.default_rng(7), n_pairs=3000)
    got = PR.assert_deadlock_free(pnet, "baseline", nonmin,
                                  np.random.default_rng(7), n_pairs=3000,
                                  device="cpu")
    assert want > 0 and got == want


@pytest.mark.parametrize("mode", MODES)
def test_trace_paths_equal_reference(nets, mode):
    """The hop walk itself: channels, VCs and lengths, also resumed
    mid-flight from arbitrary routers and metas."""
    net, pnet = nets
    rng = np.random.default_rng(4)
    Tn = net.num_terminals
    s = rng.integers(0, Tn, 400)
    d = rng.integers(0, Tn, 400)
    keep = s != d
    s, d = s[keep], d[keep]
    mis = np.full(len(s), -1)
    want = V.trace_paths(net, R.make_route_fn(net, mode), s, d, mis)
    got = PV.trace_paths(pnet, PR.make_route_fn(pnet, mode, device="cpu"),
                         s, d, mis, device="cpu")
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    u = rng.integers(0, net.num_nodes, 300)
    dr = rng.integers(0, Tn, 300)
    keep = net.term_node[dr] != u
    u, dr = u[keep], dr[keep]
    meta0 = np.full(len(u), R.PHASE_BIT | (1 << 3) | 1, dtype=np.int32)
    want = V.trace_paths(net, R.make_route_fn(net, mode), dr, dr,
                         np.full(len(u), -1), start_nodes=u, meta0=meta0)
    got = PV.trace_paths(pnet, PR.make_route_fn(pnet, mode, device="cpu"),
                         dr, dr, np.full(len(u), -1), start_nodes=u,
                         meta0=meta0, device="cpu")
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def _random_paths(rng, B, H, C, V_):
    chans = rng.integers(0, C, (B, H))
    vcs = rng.integers(0, V_, (B, H)).astype(np.int32)
    cut = rng.integers(1, H + 1, B)
    pad = np.arange(H) >= cut[:, None]
    return np.where(pad, -1, chans), np.where(pad, -1, vcs)


@pytest.mark.parametrize("seed", range(6))
def test_cdg_equals_networkx(seed):
    """Edges (as a set, duplicates and self-loops included) and the
    acyclicity verdict against networkx, on random paths: short sparse
    ones (mostly acyclic) and dense ones (cyclic)."""
    rng = np.random.default_rng(seed)
    dense = seed % 2 == 1
    chans, vcs = _random_paths(rng, 40 if dense else 6,
                               8 if dense else 3, 12 if dense else 400, 3)
    ref = V.build_cdg(chans, vcs)
    cdg = PV.build_cdg(chans, vcs)
    assert cdg.number_of_edges() == ref.number_of_edges()
    assert {((a, b), (c, d)) for a, b, c, d in cdg.edges.tolist()} == \
        set(ref.edges())
    acyclic = nx.is_directed_acyclic_graph(ref)
    assert cdg.is_acyclic() == acyclic
    cycle = cdg.find_cycle()
    if acyclic:
        assert cycle == []
    else:
        assert cycle and all(ref.has_edge(a, b) for a, b in cycle)
        assert all(a[1] == b[0] for a, b in zip(cycle, cycle[1:] + cycle[:1]))


def test_cyclic_cdg_raises_in_both(nets, monkeypatch):
    """A route whose paths close a dependency cycle fails the proof in the
    reference and in the port alike."""
    net, pnet = nets
    ring = np.array([[0, 1, 2, 0, -1]])
    vcs = np.array([[0, 0, 0, 0, -1]], dtype=np.int32)
    fake = lambda *a, **k: (ring, vcs, np.array([4]))
    monkeypatch.setattr(V, "trace_paths", fake)
    monkeypatch.setattr(PV, "trace_paths", fake)
    with pytest.raises(AssertionError, match="CDG cycle"):
        V.assert_deadlock_free(net, "updown", False,
                               np.random.default_rng(0))
    with pytest.raises(AssertionError, match="CDG cycle"):
        PV.assert_deadlock_free(pnet, "updown", False,
                                np.random.default_rng(0), device="cpu")
