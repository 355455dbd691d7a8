"""Parity of the port's PRNG (`repro_torch.random`) with `jax.random`.

Every comparison is exact: the port must draw the reference's bits for
every primitive the simulator uses, at the shapes and spans of its call
sites (traffic, injection, misrouting, the sweep's per-cycle key chain).
"""
import numpy as np
import jax
import pytest
import torch

from repro.core.engine.sweep import _key_chain as jax_key_chain
from repro_torch import random as jr
from repro_torch.core.engine.sweep import _key_chain

# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

M = 0xFFFFFFFF


def _np(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("key,count,expect", [
    ((0, 0), (0, 0), (0x6b200159, 0x99ba4efe)),
    ((M, M), (M, M), (0x1cb996fc, 0xbb002be7)),
    ((0x13198a2e, 0x03707344), (0x243f6a88, 0x85a308d3),
     (0xc4923a9c, 0x483df7a0)),
])
def test_threefry_known_answers(key, count, expect):
    y = jr.threefry2x32(*(torch.tensor(v, dtype=torch.int64)
                          for v in (*key, *count)))
    assert tuple(int(v) for v in y) == expect


@pytest.mark.parametrize("seed", [0, 1, 7, 123456, 2**31 - 1, -1])
def test_prng_key(seed):
    assert (_np(jax.random.PRNGKey(seed)) == jr.PRNGKey(seed).numpy()).all()


@pytest.mark.parametrize("num", [2, 3, 5])
def test_split(num):
    keys = [jax.random.PRNGKey(s) for s in (0, 3, 11)]
    want = np.stack([_np(jax.random.split(k, num)) for k in keys])
    got = jr.split(torch.stack([jr.PRNGKey(s) for s in (0, 3, 11)]), num)
    assert (want == got.numpy()).all()


@pytest.mark.parametrize("shape", [(), (7,), (192,), (5248,), (3, 5)])
def test_uniform(shape):
    for s in (0, 5):
        want = np.asarray(jax.random.uniform(jax.random.PRNGKey(s), shape))
        got = jr.uniform(jr.PRNGKey(s), shape).numpy()
        assert got.dtype == want.dtype == np.float32
        assert (want.view(np.int32) == got.view(np.int32)).all()


# spans of the call sites: uniform traffic draws [0, T-1) (not a power of
# two), hotspot [0, num_hot) and [0, tpg), misrouting [0, g); plus edge
# cases (empty span, negative minval, a span above 2^16)
@pytest.mark.parametrize("lo,hi", [(0, 191), (0, 5247), (0, 4), (0, 64),
                                   (0, 3), (0, 41), (0, 1), (5, 5),
                                   (-3, 100003)])
def test_randint(lo, hi):
    for s in (0, 9):
        want = np.asarray(jax.random.randint(jax.random.PRNGKey(s), (300,),
                                             lo, hi))
        got = jr.randint(jr.PRNGKey(s), (300,), lo, hi).numpy()
        assert got.dtype == want.dtype == np.int32
        assert (want == got).all()


def test_bernoulli():
    for s in (0, 4):
        want = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(s), 0.5,
                                               (192,)))
        got = jr.bernoulli(jr.PRNGKey(s), 0.5, (192,)).numpy()
        assert (want == got).all()


def test_lane_batched_draws_match_vmap():
    """A leading key dimension is the port's form of `vmap` over keys."""
    seeds = (0, 1, 2, 3)
    jkeys = jax.numpy.stack([jax.random.PRNGKey(s) for s in seeds])
    tkeys = torch.stack([jr.PRNGKey(s) for s in seeds])
    want = np.asarray(jax.vmap(
        lambda k: jax.random.randint(k, (50,), 0, 191))(jkeys))
    assert (want == jr.randint(tkeys, (50,), 0, 191).numpy()).all()
    want = np.asarray(jax.vmap(
        lambda k: jax.random.uniform(k, (50,)))(jkeys))
    assert (want == jr.uniform(tkeys, (50,)).numpy()).all()


def test_key_chain():
    """The per-cycle subkey chain of the sweep, per lane."""
    seeds = (0, 1, 7)
    want = np.stack([_np(jax_key_chain(jax.random.PRNGKey(s), 40))
                     for s in seeds], axis=1)               # [40, B, 2]
    got = _key_chain(torch.stack([jr.PRNGKey(s) for s in seeds]), 40)
    assert got.shape == (40, 3, 2)
    assert (want == got.numpy()).all()
