"""Threefry-2x32 in plain PyTorch, bit for bit JAX's default PRNG.

The reference engine draws every random number from `jax.random` with
the default implementation of jax 0.9.0: ``threefry2x32`` with
``jax_threefry_partitionable=True``.  This module reproduces exactly the
primitives the simulator's oracle path uses — `PRNGKey`, `split`,
`uniform` (float32), `randint` (int32, any span) and `bernoulli` — so a
run here and a JAX run with the same seed draw the same bits.

Representation: a key is an int64 tensor ``[..., 2]`` holding two uint32
words; every leading dimension is a batch (lane) dimension, which takes
the place of the reference's `vmap` over keys.  All arithmetic is int64
masked to 32 bits, so CPU and CUDA tensors give identical bits.  Draws
of shape `shape` from keys ``[..., 2]`` come back as ``[..., *shape]``.

Algorithms follow `jax/_src/prng.py` (`threefry_2x32`,
`_threefry_split_foldlike`, `_threefry_random_bits_partitionable`,
`iota_2x32_shape`) and `jax/_src/random.py` (`_uniform`, `_randint`,
`_bernoulli`).
"""
from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k1, k2, x0, x1):
    """The Threefry-2x32 hash (20 rounds) on broadcastable int64 tensors
    of uint32 words; returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` with 64-bit mode off: ``(0, seed mod 2^32)``."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64,
                        device=device)


def _hash(key: torch.Tensor, shape: tuple):
    """Threefry over the flat iota of `shape` (hi/lo count words), keyed
    per leading batch entry of `key`; returns both output words."""
    n = math.prod(shape)
    lo = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    hi = lo >> 32
    bshape = key.shape[:-1] + (1,) * len(shape)
    k1 = key[..., 0].reshape(bshape)
    k2 = key[..., 1].reshape(bshape)
    return threefry2x32(k1, k2, hi, lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split(key, num)`: keys ``[..., 2]`` -> ``[..., num, 2]``."""
    b1, b2 = _hash(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """32 random bits per element (uint32 values in int64)."""
    b1, b2 = _hash(key, tuple(shape))
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """`jax.random.uniform(key, shape)`: float32 in [0, 1)."""
    bits = random_bits(key, shape)
    fbits = (bits >> 9) | 0x3F800000
    return fbits.to(torch.int32).view(torch.float32) - 1.0


def randint(key: torch.Tensor, shape: tuple, minval: int,
            maxval: int) -> torch.Tensor:
    """`jax.random.randint(key, shape, minval, maxval)` (int32): two 32-bit
    draws combined by the reference's multiply-and-remainder construction,
    so spans that are not powers of two give the reference's values."""
    if not (-2**31 <= minval and maxval <= 2**31 - 1):
        raise ValueError(f"randint bounds [{minval}, {maxval}) exceed int32")
    ks = split(key)
    higher = random_bits(ks[..., 0, :], shape)
    lower = random_bits(ks[..., 1, :], shape)
    span = 1 if maxval <= minval else (maxval - minval) & M32
    mult = (2**16) % span
    mult = ((mult * mult) & M32) % span
    off = (((higher % span) * mult) & M32) + (lower % span)
    off = (off & M32) % span
    val = (off + (minval & M32)) & M32
    return torch.where(val >= 2**31, val - 2**32, val).to(torch.int32)


def bernoulli(key: torch.Tensor, p: float, shape: tuple) -> torch.Tensor:
    """`jax.random.bernoulli(key, p, shape)` (float32 threshold)."""
    # a fill, not a host copy: the draw can be captured in a CUDA graph
    return uniform(key, shape) < torch.full((), p, dtype=torch.float32,
                                            device=key.device)
