"""Per-cycle parity of the port's oracle engine step with the JAX reference.

Every `SimState` array and every `SimStats` counter (including the
float32 `lat_sum`) must equal the reference's after EVERY cycle, across
route modes (min / val / val_restricted / ugal), vc modes, pristine /
cold / warm / repair fault states, the router-death reaper, small
buffers and source queues (credit stalls, drops), and lanes carrying
different fault schedules.  Also holds the port's `take` to JAX's gather
semantics for out-of-range indices, and ports the packet-conservation
trace of `tests/conftest.py`.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import topology as JT
from repro.core import traffic as JTR
from repro.core.engine import build_lane as jax_build_lane
from repro.core.engine import make_state as jax_make_state
from repro.core.engine import make_step as jax_make_step
from repro.core.engine.stats import zero_stats as jax_zero_stats
from repro.core.simulator import SimConfig as JConfig
from repro_torch import random as jr
from repro_torch.core import topology as PT
from repro_torch.core import traffic as PTR
from repro_torch.core.engine import build_lane, make_state, make_step
from repro_torch.core.engine.state import stack_lanes
from repro_torch.core.engine.stats import zero_stats
from repro_torch.core.routing import share_lanes
from repro_torch.core.simulator import SimConfig
from repro_torch.tensors import lane_take, take

# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

SMALL = dict(a=1, b=2, m=2, n=4, noc=2, g=4)
DRAGONFLY = dict(t=2, l=4, gl=1, g=5)
STATE_FIELDS = ("b_pkt", "b_head", "b_count", "s_pkt", "s_head", "s_count",
                "ch_busy")
STAT_FIELDS = ("delivered", "lat_sum", "generated", "dropped", "stranded",
               "reaped", "occ_peak", "hops")


@pytest.fixture(scope="module")
def nets():
    return {"switchless": (JT.build_switchless(JT.SwitchlessParams(**SMALL),
                                               "eng"),
                           PT.build_switchless(PT.SwitchlessParams(**SMALL),
                                               "eng")),
            "dragonfly": (JT.build_switch_dragonfly(
                              JT.SwitchDragonflyParams(**DRAGONFLY), "df"),
                          PT.build_switch_dragonfly(
                              PT.SwitchDragonflyParams(**DRAGONFLY), "df"))}


def _faults(jnet, kind, vc_mode):
    """(reference, port) fault states of one kind: None, a cold link-fault
    set, a warm link-fault schedule, a warm router death, or router death
    then repair."""
    if kind == "pristine":
        return None, None
    rng = np.random.default_rng(5)
    if kind in ("cold", "warm"):
        types = ((JT.GLOBAL,) if vc_mode == "baseline"
                 else (JT.MESH, JT.LOCAL, JT.GLOBAL))
        f = JT.sample_link_faults(jnet, 0.15, rng, types=types,
                                  vc_mode=vc_mode)
        epochs = ((0, f),) if kind == "cold" else ((0, JT.FaultSet()),
                                                   (15, f))
    else:
        f = JT.sample_router_faults(jnet, 2, rng, vc_mode=vc_mode)
        epochs = ((0, JT.FaultSet()), (12, f))
        if kind == "repair":
            epochs += ((28, JT.FaultSet()),)
    if kind == "cold":
        return f, PT.FaultSet(f.dead_ch, f.dead_routers)
    return (JT.FaultSchedule(epochs),
            PT.FaultSchedule(tuple((c, PT.FaultSet(g.dead_ch, g.dead_routers))
                                   for c, g in epochs)))


def _check(js, ps, lane, t):
    for f in STATE_FIELDS:
        a, b = np.asarray(getattr(js, f)), getattr(ps, f)[lane].numpy()
        assert a.shape == b.shape and (a == b).all(), f"cycle {t}: {f}"
    for f in STAT_FIELDS:
        a = np.asarray(getattr(js.stats, f))
        b = getattr(ps.stats, f)[lane].numpy()
        assert a.dtype == b.dtype and (a == b).all(), f"cycle {t}: {f}"


def _jax_lane(jnet, jcfg, jfaults, pattern):
    step, consts = jax_make_step(jnet, jcfg, pattern)
    return (jax.jit(step), jax_build_lane(jnet, jcfg, jfaults),
            jax_make_state(jnet, jcfg, consts["NV"]))


# (net kind, config overrides, fault kind, offered packet rate)
CASES = [
    ("switchless", dict(), "pristine", 0.5),
    ("switchless", dict(route_mode="val", srcq_pkts=4, buf_pkts=2),
     "pristine", 0.9),
    ("switchless", dict(route_mode="ugal"), "cold", 0.6),
    ("switchless", dict(vc_mode="updown", vcs_per_class=1), "warm", 0.6),
    ("switchless", dict(vc_mode="updown", route_mode="ugal",
                        vcs_per_class=3), "warm", 0.7),
    ("switchless", dict(vc_mode="updown_merged",
                        route_mode="val_restricted"), "warm", 0.6),
    ("switchless", dict(vc_mode="updown", reap_age=6), "router", 0.6),
    ("switchless", dict(vc_mode="updown", route_mode="val", reap_age=5),
     "repair", 0.6),
    ("switchless", dict(vc_mode="updown"), "repair", 0.6),
    ("dragonfly", dict(route_mode="ugal"), "cold", 0.8),
    ("dragonfly", dict(route_mode="val", buf_pkts=2), "pristine", 0.8),
]


@pytest.mark.parametrize("net_kind,over,fault_kind,rate", CASES)
def test_step_parity_per_cycle(nets, net_kind, over, fault_kind, rate,
                               cycles=32, reset_at=16):
    jnet, pnet = nets[net_kind]
    jcfg, pcfg = JConfig(**over), SimConfig(**over)
    jf, pf = _faults(jnet, fault_kind, jcfg.vc_mode)
    jstep, jfl, js = _jax_lane(jnet, jcfg, jf, JTR.uniform(jnet))
    pstep, consts = make_step(pnet, pcfg, PTR.uniform(pnet), device="cpu")
    pfl = share_lanes(build_lane(pnet, pcfg, pf, device="cpu"), 1)
    ps = make_state(pnet, pcfg, consts["NV"], batch=(1,), device="cpu")
    jkey, pkey = jax.random.PRNGKey(3), jr.PRNGKey(3)[None]
    rate_t = torch.tensor([rate], dtype=torch.float32)
    moved = 0
    for t in range(cycles):
        jkey, jsub = jax.random.split(jkey)
        ks = jr.split(pkey)
        pkey, psub = ks[:, 0], ks[:, 1]
        js, _ = jstep(js, (jnp.int32(t), jsub, jnp.float32(rate), jfl))
        ps, _ = pstep(ps, (t, psub, rate_t, pfl))
        if t == reset_at:
            js = js.replace(stats=jax_zero_stats(js.stats))
            ps = ps.replace(stats=zero_stats(ps.stats))
        _check(js, ps, 0, t)
        moved += int(np.asarray(js.stats.hops).sum())
    assert moved > 0, "no packet moved: the parity test is vacuous"


def test_lanes_with_different_schedules_select_their_own_epochs(nets):
    """Two lanes stacked with different warm schedules (and epoch counts)
    each follow their own epochs, equal to two reference lanes."""
    jnet, pnet = nets["switchless"]
    over = dict(vc_mode="updown", route_mode="ugal")
    jcfg, pcfg = JConfig(**over), SimConfig(**over)
    lanes = [_faults(jnet, "warm", "updown"), _faults(jnet, "repair",
                                                      "updown")]
    jlanes = [_jax_lane(jnet, jcfg, jf, JTR.uniform(jnet))
              for jf, _ in lanes]
    pstep, consts = make_step(pnet, pcfg, PTR.uniform(pnet), device="cpu")
    pfl = stack_lanes([build_lane(pnet, pcfg, pf, device="cpu")
                       for _, pf in lanes])
    assert tuple(pfl["epoch_start"].shape) == (2, 3)
    ps = make_state(pnet, pcfg, consts["NV"], batch=(2,), device="cpu")
    jkeys = [jax.random.PRNGKey(s) for s in (0, 1)]
    pkeys = torch.stack([jr.PRNGKey(s) for s in (0, 1)])
    rate = 0.6
    rate_t = torch.full((2,), rate, dtype=torch.float32)
    for t in range(32):
        ks = jr.split(pkeys)
        pkeys, psub = ks[:, 0], ks[:, 1]
        ps, _ = pstep(ps, (t, psub, rate_t, pfl))
        for b, (jstep, jfl, js) in enumerate(jlanes):
            jkeys[b], jsub = jax.random.split(jkeys[b])
            js, _ = jstep(js, (jnp.int32(t), jsub, jnp.float32(rate), jfl))
            jlanes[b] = (jstep, jfl, js)
            _check(js, ps, b, t)


def test_take_matches_jax_gather_semantics():
    """Negative indices wrap once, anything still out of range clamps —
    for static and per-lane tables alike."""
    rng = np.random.default_rng(0)
    tbl = rng.integers(0, 100, (5, 4, 3)).astype(np.int32)
    idx = [rng.integers(-12, 12, (2, 50)).astype(np.int32) for _ in range(3)]
    want = np.asarray(jnp.asarray(tbl)[tuple(jnp.asarray(i) for i in idx)])
    got = take(torch.as_tensor(tbl), *(torch.as_tensor(i) for i in idx))
    assert (want == got.numpy()).all()
    lanes = rng.integers(0, 100, (2, 7, 3)).astype(np.int32)
    want = np.stack([np.asarray(jnp.asarray(lanes[b])[
        jnp.asarray(idx[0][b]), jnp.asarray(idx[1][b])]) for b in range(2)])
    got = lane_take(torch.as_tensor(lanes), torch.as_tensor(idx[0]),
                    torch.as_tensor(idx[1]))
    assert (want == got.numpy()).all()


def conservation_trace(net, cfg, pattern=None, faults=None, *, cycles,
                       rate, stop_inject_at=None, prng_seed=3):
    """The port's form of `tests/conftest.py:conservation_trace`: step the
    port's engine cycle by cycle and assert
    ``generated == delivered + dropped + reaped + in-flight`` at every
    cycle; injection stops at `stop_inject_at`.  Returns one dict per
    cycle."""
    if pattern is None:
        pattern = PTR.uniform(net)
    step, consts = make_step(net, cfg, pattern, device="cpu")
    fl = share_lanes(build_lane(net, cfg, faults, device="cpu"), 1)
    state = make_state(net, cfg, consts["NV"], batch=(1,), device="cpu")
    key = jr.PRNGKey(prng_seed)[None]
    trace = []
    for t in range(cycles):
        ks = jr.split(key)
        key, sub = ks[:, 0], ks[:, 1]
        r = rate if (stop_inject_at is None or t < stop_inject_at) else 0.0
        state, _ = step(state, (t, sub, torch.tensor([r]), fl))
        st = state.stats
        rec = dict(t=t, generated=int(st.generated[0]),
                   delivered=int(st.delivered[0]),
                   dropped=int(st.dropped[0]), reaped=int(st.reaped[0]),
                   stranded=int(st.stranded[0]),
                   inflight=int(state.b_count.sum())
                   + int(state.s_count.sum()))
        assert rec["generated"] == (rec["delivered"] + rec["dropped"]
                                    + rec["reaped"] + rec["inflight"]), \
            f"conservation leak at cycle {t}: {rec}"
        trace.append(rec)
    return trace


def test_conservation_with_router_death_and_reaper(nets):
    """Warm router death strands packets; the reaper removes every one of
    them once injection stops, and conservation is exact throughout."""
    jnet, pnet = nets["switchless"]
    _, sched = _faults(jnet, "router", "updown")
    reap_age, stop = 10, 40
    trace = conservation_trace(
        pnet, SimConfig(vc_mode="updown", reap_age=reap_age), faults=sched,
        cycles=80, rate=0.5, stop_inject_at=stop)
    assert trace[-1]["reaped"] > 0
    # every packet was generated before `stop`, so from stop + reap_age on
    # no parked packet survives a cycle
    assert all(r["stranded"] == 0 for r in trace
               if r["t"] >= stop + reap_age)
