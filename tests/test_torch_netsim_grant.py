"""Parity of the port's grant (`repro_torch.kernels.netsim`) with the JAX
reference's `grant_ref` and Pallas `grant` (interpret mode).

On the CPU `ops.grant` runs the plain PyTorch version `ref.grant_ref`;
both are held exactly to the reference on live engine states (driven by
the reference engine, as `tests/test_netsim_kernel.py` does) and on
random inputs with stranded (`out = -1`) rows and many ties, with and
without a leading lane dimension.  The CUDA kernel itself is held to
`grant_ref` on the card by `tests/test_torch_cuda.py` and `chip_smoke.py`.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import engine
from repro.core import topology as T
from repro.core import traffic as TR
from repro.core.engine import build_lane, make_state
from repro.core.engine.arbitrate import expand_vcs, gather_requests
from repro.core.simulator import SimConfig
from repro.core.topology import EJECT
from repro.kernels.netsim import grant as jax_grant
from repro.kernels.netsim import grant_ref as jax_grant_ref
from repro_torch.kernels.netsim import grant, grant_ref

# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def net():
    return T.build_switchless(
        T.SwitchlessParams(a=2, b=2, m=2, n=4, noc=2, g=3), "netsim-grant")


def _faults_for(net, vc_mode):
    rng = np.random.default_rng(7)
    if vc_mode == "baseline":      # baseline can only route around globals
        return T.sample_link_faults(net, 0.2, rng, types=(T.GLOBAL,),
                                    vc_mode=vc_mode)
    return T.sample_link_faults(net, 0.08, rng, vc_mode=vc_mode)


def _drive(net, cfg, fl, cycles=8, rate=0.6):
    """Grant inputs of live reference engine states, cycle by cycle."""
    consts, route_kernel = engine.build_consts(net, cfg)
    inject = engine.make_inject_fn(net, cfg, consts, TR.uniform(net))
    apply_moves = engine.make_apply_fn(net, cfg, consts)

    @jax.jit
    def cycle(state, t, sub):
        state = inject(state, t, sub, jnp.float32(rate), fl)
        req = gather_requests(state, consts, route_kernel, fl, t)
        req = expand_vcs(req, state, cfg)
        args = (req.out, req.itime, req.valid, req.ovc_count,
                req.otype == EJECT, state.ch_busy, fl["ch_alive"])
        win, won = jax_grant_ref(*args, buf_pkts=cfg.buf_pkts)
        return apply_moves(state, req, win, won, t), args

    state = make_state(net, cfg, consts["NV"])
    key = jax.random.PRNGKey(0)
    out = []
    for t in range(cycles):
        key, sub = jax.random.split(key)
        state, args = cycle(state, jnp.int32(t), sub)
        out.append([np.array(a) for a in args])
    return out


@functools.partial(jax.jit, static_argnames="buf_pkts")
def _jax_kernel(*args, buf_pkts):
    return jax_grant(*args, buf_pkts=buf_pkts, interpret=True)


def _both(args, buf_pkts):
    """(reference grant_ref, reference Pallas grant), as numpy."""
    j = [jnp.asarray(a) for a in args]
    ref = jax_grant_ref(*j, buf_pkts=buf_pkts)
    ker = _jax_kernel(*j, buf_pkts=buf_pkts)
    return [tuple(np.asarray(x) for x in r) for r in (ref, ker)]


def _port(fn, args, buf_pkts):
    win, won = fn(*(torch.as_tensor(a) for a in args), buf_pkts=buf_pkts)
    return win.numpy(), won.numpy()


@pytest.mark.parametrize("vc_mode", ["baseline", "updown", "updown_merged"])
@pytest.mark.parametrize("faulted", [False, True])
def test_grant_parity_engine_states(net, vc_mode, faulted):
    cfg = SimConfig(vc_mode=vc_mode, vcs_per_class=2)
    fl = build_lane(net, cfg, _faults_for(net, vc_mode) if faulted else None)
    saw_grant = False
    for args in _drive(net, cfg, fl):
        want = _both(args, cfg.buf_pkts)
        assert all((a == b).all() for a, b in zip(*want))
        for fn in (grant_ref, grant):
            got = _port(fn, args, cfg.buf_pkts)
            assert all((a == b).all() for a, b in zip(want[0], got))
        saw_grant = saw_grant or bool(want[0][0].any())
    assert saw_grant, "drive produced no grants: the parity test is vacuous"


def _random_inputs(rng, N, E):
    """Rows crowding few channels (ties on itime AND channel), stranded
    rows, busy/dead channels, and credit-less non-eject rows."""
    return [rng.integers(-1, E, N).astype(np.int32),
            rng.integers(0, 4, N).astype(np.int32),
            rng.random(N) < 0.8,
            rng.integers(0, 10, N).astype(np.int32),
            rng.random(N) < 0.2,
            (rng.integers(0, 3, E) * (rng.random(E) < 0.3)).astype(np.int32),
            rng.random(E) < 0.9]


@pytest.mark.parametrize("N,E", [(1, 1), (37, 5), (700, 131), (4099, 291)])
def test_grant_parity_random_unbatched(N, E):
    rng = np.random.default_rng(N)
    args = _random_inputs(rng, N, E)
    want = _both(args, 8)
    for fn in (grant_ref, grant):
        got = _port(fn, args, 8)
        assert all((a == b).all() for a, b in zip(want[0], got))


@pytest.mark.parametrize("B", [1, 4])
def test_grant_parity_random_lanes(B):
    """A leading lane dimension equals the reference per lane (its vmap)."""
    rng = np.random.default_rng(B)
    lanes = [_random_inputs(rng, 999, 77) for _ in range(B)]
    args = [np.stack(col) for col in zip(*lanes)]
    for fn in (grant_ref, grant):
        win, won = _port(fn, args, 8)
        for b in range(B):
            want = _both(lanes[b], 8)[0]
            assert (win[b] == want[0]).all() and (won[b] == want[1]).all()


def test_cpu_grant_is_the_plain_version_and_counts_no_launch():
    rng = np.random.default_rng(0)
    args = [torch.as_tensor(a) for a in _random_inputs(rng, 50, 9)]
    before = grant.launches
    got = grant(*args, buf_pkts=8)
    want = grant_ref(*args, buf_pkts=8)
    assert grant.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))



# --- the CUDA wrapper's rule and checks, which need no card -----------------

from repro_torch.kernels.netsim import ops as netsim_ops


@pytest.mark.parametrize("explicit_prio,want", [
    (False, "coop"),         # every grant call; the fused step
    (True, "three_pass"),    # the compact step
])
def test_kernel_for_rule(explicit_prio, want):
    assert netsim_ops.kernel_for(explicit_prio) == want


# each registered paper network's channels E and request rows N a lane
# (`fused.compact_rows`), as PERF.md lists them
PAPER_NETWORKS = [
    ("paper_radix16_switchless", 30176, 204672),
    ("paper_radix16_dragonfly", 6560, 43296),
    ("paper_radix32_dragonfly", 92800, 612480),
    ("paper_radix32_switchless", 241280, 1670400),
]


@pytest.mark.parametrize("params,E,N", PAPER_NETWORKS)
def test_paper_networks_land_on_the_one_launch_kernel(params, E, N):
    """At 4 lanes every registered paper network's oracle grant and fused
    step run the coop kernel, its compact step (explicit priority, C =
    ceil(N / 4) rows) the three-pass one, within its lane limit."""
    from repro_torch.core import topology as T
    from repro_torch.core.engine.fused import compact_rows
    from repro_torch.core.simulator import SimConfig
    p = getattr(T, params)()
    build = (T.build_switchless if isinstance(p, T.SwitchlessParams)
             else T.build_switch_dragonfly)
    net = build(p, params)
    assert (net.num_channels, compact_rows(net, SimConfig())) == (E, N)
    assert netsim_ops._pick("grant", None, 4) == "coop"
    assert netsim_ops._pick("cycle_core", None, 4, False) == "coop"
    assert netsim_ops._pick("cycle_core", None, 4, True) == "three_pass"


def test_pick_refuses_what_a_kernel_cannot_take():
    with pytest.raises(ValueError, match="row-index priority"):
        netsim_ops._pick("cycle_core", "coop", 4, True)
    with pytest.raises(ValueError, match="lanes"):
        netsim_ops._pick("grant", "three_pass", 65536)
    assert netsim_ops._pick("grant", None, 65536) == "coop"
    assert netsim_ops._pick("grant", "three_pass", 4) == "three_pass"


def _good_grant_args(B=2, N=8, E=3):
    rng = np.random.default_rng(0)
    cols = [np.stack(c) for c in zip(*(_random_inputs(rng, N, E)
                                       for _ in range(B)))]
    return [torch.as_tensor(c) for c in cols]


@pytest.mark.parametrize("index,bad,match", [
    (0, lambda x: x.float(), "out must be torch.int32"),
    (1, lambda x: x.long(), "itime must be torch.int32"),
    (2, lambda x: x.int(), "valid must be torch.bool"),
    (3, lambda x: x[:, :-1], "ovc_count must be torch.int32 of shape"),
    (4, lambda x: x.int(), "is_eject must be torch.bool"),
    (5, lambda x: x[:1], "ch_busy must be torch.int32 of shape"),
    (6, lambda x: torch.cat([x, x], 1)[:, ::2],
     "contiguous along the channel axis"),
])
def test_grant_operands_rejections(index, bad, match):
    args = _good_grant_args()
    args[index] = bad(args[index])
    with pytest.raises(ValueError, match=match):
        netsim_ops.grant_operands(*args)


def test_grant_operands_empty_and_contiguous_rows():
    args = _good_grant_args()
    with pytest.raises(ValueError, match="empty problem"):
        netsim_ops.grant_operands(*(x[:, :0] if i < 5 else x
                                    for i, x in enumerate(args)))
    strided = [torch.stack([x, x], -1).flatten(1)[:, ::2] if i < 5 else x
               for i, x in enumerate(args)]
    assert not strided[0].is_contiguous()
    rows, B, N, E = netsim_ops.grant_operands(*strided)
    assert (B, N, E) == (2, 8, 3)
    assert all(r.is_contiguous() and torch.equal(r, a)
               for r, a in zip(rows, args))


def test_wrapper_rejects_devices_and_kernel_names():
    args = _good_grant_args()
    meta = [x.to("meta") for x in args]
    with pytest.raises(ValueError, match="several devices"):
        grant(*args[:6], meta[6], buf_pkts=8)
    with pytest.raises(ValueError, match="unsupported device"):
        grant(*meta, buf_pkts=8)
    with pytest.raises(ValueError, match="kernel must be one of"):
        grant(*args, buf_pkts=8, kernel="cluster")


@pytest.mark.parametrize("kernel", netsim_ops.KERNELS)
def test_cpu_named_kernel_runs_the_plain_version(kernel):
    """On the CPU a named kernel still runs the plain version and counts
    no launch."""
    args = _good_grant_args(B=3, N=40, E=7)
    before = grant.launches, dict(grant.launches_by_kernel)
    got = grant(*args, buf_pkts=8, kernel=kernel)
    want = grant_ref(*args, buf_pkts=8)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (grant.launches, grant.launches_by_kernel) == before
