"""Bit-exact torch port of JAX's default PRNG.

The reference engine draws every random number from `jax.random` with
the default implementation of jax 0.9.0: ``threefry2x32`` with
``jax_threefry_partitionable=True``.  This module reproduces exactly the
primitives the simulator's oracle path uses — `PRNGKey`, `split`,
`uniform` (float32), `randint` (int32, any span) and `bernoulli` — so a
port run and a reference run with the same seed draw the same bits.

Representation: a key is an int64 tensor ``[..., 2]`` holding two uint32
words; every leading dimension is a batch (lane) dimension, which takes
the place of the reference's `vmap` over keys.  Draws of shape `shape`
from keys ``[..., 2]`` come back as ``[..., *shape]``.

The key's device picks the path: on a CUDA key each draw is one launch
of the netsim library's Threefry kernel (`kernels.netsim.ops`,
``csrc/threefry.cu``, one thread an output element); on a CPU key it is
the plain version (`kernels.netsim.ref`), int64 tensor operations masked
to 32 bits.  Both give the same bits.

Algorithms follow `jax/_src/prng.py` (`threefry_2x32`,
`_threefry_split_foldlike`, `_threefry_random_bits_partitionable`,
`iota_2x32_shape`) and `jax/_src/random.py` (`_uniform`, `_randint`,
`_bernoulli`).
"""
from __future__ import annotations

import torch

from .kernels.netsim import ops as _netsim
from .kernels.netsim.ref import M32, threefry2x32

__all__ = ["M32", "PRNGKey", "bernoulli", "randint", "random_bits", "split",
           "threefry2x32", "uniform"]


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` with 64-bit mode off: ``(0, seed mod 2^32)``."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64,
                        device=device)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split(key, num)`: keys ``[..., 2]`` -> ``[..., num, 2]``."""
    return _netsim.threefry_split(key, num)


def random_bits(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """32 random bits per element (uint32 values in int64)."""
    return _netsim.threefry_bits(key, shape)


def uniform(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """`jax.random.uniform(key, shape)`: float32 in [0, 1)."""
    return _netsim.threefry_uniform(key, shape)


def randint(key: torch.Tensor, shape: tuple, minval: int,
            maxval: int) -> torch.Tensor:
    """`jax.random.randint(key, shape, minval, maxval)` (int32): two 32-bit
    draws combined by the reference's multiply-and-remainder construction,
    so spans that are not powers of two give the reference's values."""
    return _netsim.threefry_randint(key, shape, minval, maxval)


def bernoulli(key: torch.Tensor, p: float, shape: tuple) -> torch.Tensor:
    """`jax.random.bernoulli(key, p, shape)` (float32 threshold)."""
    return _netsim.threefry_bernoulli(key, p, shape)
