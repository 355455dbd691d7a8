"""Per-cycle parity of the port's fused cycle step (`step_impl="fused"`)
with the JAX reference's.

After EVERY cycle, every `SimState` array (including the 8-field `b_pkt`
record with its cached-route tail) and every `SimStats` counter must
equal the reference fused step's, lane for lane, across the reference's
`tests/test_fused_step.py` cases (vc modes x route modes x VCs per
class) on pristine, cold-fault and warm-fault lanes (warm lanes take the
per-cycle routing fallback), and with the router-death reaper on.  The
reference runs with both of its grants: the jnp segment-min and the
Pallas `cycle_core` kernel in interpret mode.  On the CPU the port's
step runs `cycle_core_ref`, the plain version of its CUDA kernel.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
torch = pytest.importorskip("torch")

from repro.core import topology as JT
from repro.core import traffic as JTR
from repro.core.engine import build_lane as jax_build_lane
from repro.core.engine import make_state as jax_make_state
from repro.core.engine import make_step as jax_make_step
from repro.core.engine.fused import grant_form as jax_grant_form
from repro.core.engine.fused import make_compact_step as \
    jax_make_compact_step
from repro.core.engine.stats import zero_stats as jax_zero_stats
from repro.core.simulator import SimConfig as JConfig
from repro_torch import random as jr
from repro_torch.core import topology as PT
from repro_torch.core import traffic as PTR
from repro_torch.core.engine import build_lane, make_state, make_step
from repro_torch.core.engine.fused import grant_form, make_compact_step
from repro_torch.core.engine.stats import zero_stats
from repro_torch.core.engine.sweep import offered_to_rate_pkt
from repro_torch.core.routing import share_lanes
from repro_torch.core.simulator import SimConfig
from repro_torch.kernels.netsim import ops as netsim_ops

# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

PARAMS = dict(a=1, b=1, m=2, n=6, noc=2, g=3)
WARMUP, MEASURE = 40, 140
RATES, SEEDS = (0.4, 1.2), (0, 1)
STATE_FIELDS = ("b_pkt", "b_head", "b_count", "s_pkt", "s_head", "s_count",
                "ch_busy")
STAT_FIELDS = ("delivered", "lat_sum", "generated", "dropped", "stranded",
               "reaped", "occ_peak", "hops")


@pytest.fixture(scope="module")
def nets():
    return (JT.build_switchless(JT.SwitchlessParams(**PARAMS), "fused-par"),
            PT.build_switchless(PT.SwitchlessParams(**PARAMS), "fused-par"))


def fault_pair(jnet, vc_mode, kind, onset=60):
    """(reference, port) fault states: None, the reference test's cold
    set (two dead global channels for baseline, two dead routers
    otherwise) or that set switched on at cycle `onset`."""
    if kind == "pristine":
        return None, None
    if vc_mode == "baseline":
        glob = np.where(np.asarray(jnet.ch_type) == JT.GLOBAL)[0]
        dead_ch, dead_r = tuple(int(c) for c in glob[:2]), ()
    else:
        dead_ch, dead_r = (), (5, 11)
    jf = JT.FaultSet(dead_ch=frozenset(dead_ch),
                     dead_routers=frozenset(dead_r))
    pf = PT.FaultSet(dead_ch, dead_r)
    if kind == "cold":
        return jf, pf
    return (JT.FaultSchedule(((0, JT.FaultSet()), (onset, jf))),
            PT.FaultSchedule(((0, PT.FaultSet()), (onset, pf))))


def check_state(js, ps, t):
    for f in STATE_FIELDS:
        a, b = np.asarray(getattr(js, f)), getattr(ps, f).numpy()
        assert a.shape == b.shape and (a == b).all(), f"cycle {t}: {f}"
    for f in STAT_FIELDS:
        a = np.asarray(getattr(js.stats, f))
        b = getattr(ps.stats, f).numpy()
        assert a.dtype == b.dtype and (a == b).all(), f"cycle {t}: {f}"


_split_lanes = jax.jit(jax.vmap(jax.random.split))


def run_parity(nets, over, kind, grant_impls=("jnp", "pallas"),
               capacity=None):
    """Step the reference (once per grant impl, lanes vmapped) and the
    port (lanes batched) through WARMUP + MEASURE cycles over the
    (RATES x SEEDS) lanes, comparing everything after every cycle.
    `capacity` pins both compact steps to one rung.  Returns the port's
    final state."""
    jnet, pnet = nets
    jf, pf = fault_pair(jnet, over.get("vc_mode", "baseline"), kind)
    pcfg = SimConfig(warmup=WARMUP, measure=MEASURE, **over)
    if capacity is None:
        port_step, consts = make_step(pnet, pcfg, PTR.uniform(pnet),
                                      device="cpu")
    else:
        port_step, consts = make_compact_step(
            pnet, pcfg, PTR.uniform(pnet), capacity=capacity, device="cpu")
    lanes = [(r, s) for r in RATES for s in SEEDS]
    B = len(lanes)
    tpc = pnet.num_terminals / pnet.num_chips
    rates = [offered_to_rate_pkt(r, pcfg, tpc) for r, _ in lanes]
    refs = []
    for gi in grant_impls:
        jcfg = JConfig(warmup=WARMUP, measure=MEASURE, grant_impl=gi, **over)
        if capacity is None:
            step, jconsts = jax_make_step(jnet, jcfg, JTR.uniform(jnet))
        else:
            step, jconsts = jax_make_compact_step(
                jnet, jcfg, JTR.uniform(jnet), capacity=capacity)
        vstep = jax.jit(jax.vmap(step, in_axes=(0, (None, 0, 0, None))))
        refs.append([vstep, jax_build_lane(jnet, jcfg, jf),
                     jax_make_state(jnet, jcfg, jconsts["NV"], batch=(B,))])
    jkeys = jnp.stack([jax.random.PRNGKey(s) for _, s in lanes])
    jrates = jnp.asarray(rates, jnp.float32)
    pfl = share_lanes(build_lane(pnet, pcfg, pf, device="cpu"), B)
    ps = make_state(pnet, pcfg, consts["NV"], batch=(B,), device="cpu")
    pkeys = torch.stack([jr.PRNGKey(s) for _, s in lanes])
    prates = torch.tensor(rates, dtype=torch.float32)
    for t in range(WARMUP + MEASURE):
        ks = _split_lanes(jkeys)
        jkeys, jsub = ks[:, 0], ks[:, 1]
        pk = jr.split(pkeys)
        pkeys, psub = pk[:, 0], pk[:, 1]
        ps, _ = port_step(ps, (t, psub, prates, pfl))
        if t == WARMUP:
            ps = ps.replace(stats=zero_stats(ps.stats))
        for ref in refs:
            vstep, jfl, js = ref
            js, _ = vstep(js, (jnp.int32(t), jsub, jrates, jfl))
            if t == WARMUP:
                js = js.replace(stats=jax_zero_stats(js.stats))
            ref[2] = js
            check_state(js, ps, t)
    assert int(ps.stats.delivered.min()) > 0, "vacuous: nothing delivered"
    return ps


# the reference's tests/test_fused_step.py CASES
CASES = [("baseline", "min", 2), ("baseline", "ugal", 1),
         ("updown", "val", 2), ("updown_merged", "min", 2)]


@pytest.mark.parametrize("vc_mode,route_mode,vpc", CASES)
@pytest.mark.parametrize("kind", ["pristine", "cold", "warm"])
def test_fused_step_parity_per_cycle(nets, vc_mode, route_mode, vpc, kind):
    run_parity(nets, dict(vc_mode=vc_mode, route_mode=route_mode,
                          vcs_per_class=vpc, step_impl="fused"), kind)


def test_fused_step_parity_with_reaper(nets):
    """Warm router death with the reaper on: reaped rows pop from the
    per-row mask like winners; both counters track the reference."""
    ps = run_parity(nets, dict(vc_mode="updown", route_mode="min",
                               reap_age=12, step_impl="fused"), "warm",
                    grant_impls=("jnp",))
    assert int(ps.stats.reaped.sum()) > 0, "vacuous: nothing reaped"


def test_fused_step_runs_the_arbitration_core_on_cpu(nets):
    """The CPU step takes `cycle_core`'s plain version and counts no
    kernel launch; `make_step` honours the device rule."""
    _, pnet = nets
    cfg = SimConfig(step_impl="fused")
    before = netsim_ops.cycle_core.launches
    step, consts = make_step(pnet, cfg, PTR.uniform(pnet), device="cpu")
    fl = share_lanes(build_lane(pnet, cfg, None, device="cpu"), 1)
    state = make_state(pnet, cfg, consts["NV"], batch=(1,), device="cpu")
    assert state.b_pkt.shape[-1] == 8
    # the channel-sharded step builds and runs its plain grant too (the
    # global minimum exists only after the shards' exchange)
    from repro_torch.core.engine.fused import make_fused_step
    sstep, _ = make_fused_step(pnet, cfg, PTR.uniform(pnet), shards=2,
                               device="cpu")
    states = sstep.make_states((1,))
    rate = torch.tensor([0.5])
    for t in range(5):
        key = jr.PRNGKey(t)[None]
        state, _ = step(state, (t, key, rate, fl))
        states, _ = sstep(states, (t, sstep.place(key), sstep.place(rate),
                                   sstep.place(fl)))
    assert netsim_ops.cycle_core.launches == before
    got = sstep.gather(states)
    assert torch.equal(got.b_pkt, state.b_pkt)
    assert torch.equal(got.s_count, state.s_count)


@pytest.mark.parametrize("net_name,cycles,want", [
    ("small", 180, "combined"), ("small", 2_000_000, "two_pass"),
    ("radix16", 1500, "combined"), ("radix16", 10000, "two_pass")])
def test_grant_form_matches_reference(net_name, cycles, want):
    """`grant_form` reports the reference's form, including "two_pass"
    where the packed int32 key would overflow — the paper's radix-16
    network at its 10,000-cycle runs (reporting only: the port's 64-bit
    key serves both)."""
    if net_name == "small":
        jnet = JT.build_switchless(JT.SwitchlessParams(**PARAMS), "gf")
        pnet = PT.build_switchless(PT.SwitchlessParams(**PARAMS), "gf")
    else:
        jnet = JT.build_switchless(JT.paper_radix16_switchless(), "gf")
        pnet = PT.build_switchless(PT.paper_radix16_switchless(), "gf")
    kw = dict(warmup=cycles // 5, measure=cycles - cycles // 5)
    assert jax_grant_form(jnet, JConfig(**kw)) == want
    assert grant_form(pnet, SimConfig(**kw)) == want
