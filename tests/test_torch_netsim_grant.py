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

