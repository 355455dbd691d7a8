"""Traffic patterns for the network simulator (paper Sec. V-A3).

A pattern is a closure
`sample(key, t) -> dest` giving, for every source terminal, the
destination terminal it would use for a packet generated this cycle.
Keys are ``[..., 2]`` tensors of `prng`; every leading key
dimension is a lane, so ``sample(keys[B, 2], t) -> dest[B, T]`` (int32) —
the lane dimension takes the place of the reference's `vmap`.  Random
patterns draw the reference's exact bits; permutation patterns ignore
the key and broadcast.

Every public factory returns a `TrafficPattern` `(sample, inject_mask)`
pair; `PATTERNS` is the by-name registry resolved by `make_pattern`.
"""
from __future__ import annotations

import inspect
from typing import Callable, NamedTuple

import numpy as np
import torch

from . import prng as jr
from .topology import Network


class TrafficPattern(NamedTuple):
    """Normalized traffic pattern: per-lane sampler + optional source mask.

    `sample(key, t) -> dest`; `inject_mask` is a bool [T] numpy array of
    terminals allowed to inject, or None for "all terminals".  The tuple is
    callable (delegates to `sample`).
    """

    sample: Callable
    inject_mask: object = None

    def __call__(self, key, t):
        return self.sample(key, t)


def as_pattern(pattern, inject_mask=None) -> TrafficPattern:
    """Normalize a sampler / (sample, mask) pair into a `TrafficPattern`;
    an explicit `inject_mask` composes (AND) with the pattern's own."""
    if isinstance(pattern, TrafficPattern):
        sample, mask = pattern.sample, pattern.inject_mask
    elif isinstance(pattern, tuple):
        sample, mask = pattern
    else:
        sample, mask = pattern, None
    if inject_mask is not None:
        extra = np.asarray(inject_mask).astype(bool)
        mask = extra if mask is None \
            else np.asarray(mask).astype(bool) & extra
    return TrafficPattern(sample, mask)


def _per_device(arr: np.ndarray):
    """`get(device)` -> `arr` as an int32 tensor on `device`, copied once
    per device (patterns are built before the run's device is known)."""
    cache = {}

    def get(device):
        t = cache.get(device)
        if t is None:
            t = cache[device] = torch.as_tensor(
                np.asarray(arr)).to(device=device, dtype=torch.int32)
        return t

    return get


def _bits(n: int) -> int:
    return max(1, int(np.ceil(np.log2(max(n, 2)))))


def _guard(dest: np.ndarray, T: int) -> np.ndarray:
    """Out-of-range destinations (non-power-of-two T) map to self; the
    simulator treats dest == src as "don't inject"."""
    src = np.arange(len(dest))
    return np.where(dest >= T, src, dest)


def uniform(net: Network) -> TrafficPattern:
    T = net.num_terminals

    def sample(key, t):
        src = torch.arange(T, dtype=torch.int32, device=key.device)
        d = jr.randint(key, (T,), 0, T - 1)
        return torch.where(d >= src, d + 1, d)  # uniform over T-1 others

    return TrafficPattern(sample)


def _perm_pattern(dest_np: np.ndarray) -> TrafficPattern:
    dest = _per_device(dest_np)
    T = len(dest_np)

    def sample(key, t):
        return dest(key.device).expand(key.shape[:-1] + (T,))

    return TrafficPattern(sample)


def bit_reverse(net: Network):
    T = net.num_terminals
    b = _bits(T)
    src = np.arange(T)
    d = np.zeros(T, dtype=np.int64)
    for i in range(b):
        d |= (((src >> i) & 1) << (b - 1 - i))
    return _perm_pattern(_guard(d, T))


def bit_shuffle(net: Network):
    """Rotate address bits left by one."""
    T = net.num_terminals
    b = _bits(T)
    src = np.arange(T)
    d = ((src << 1) | (src >> (b - 1))) & ((1 << b) - 1)
    return _perm_pattern(_guard(d, T))


def bit_transpose(net: Network):
    """Swap upper/lower halves of the address bits."""
    T = net.num_terminals
    b = _bits(T)
    h = b // 2
    src = np.arange(T)
    lo = src & ((1 << h) - 1)
    hi = src >> h
    d = (lo << (b - h)) | hi
    return _perm_pattern(_guard(d, T))


def _terms_per_group(net: Network) -> int:
    for key in ("terms_per_wg", "terms_per_grp"):
        if key in net.meta:
            return net.meta[key]
    raise KeyError(
        "group-structured traffic needs net.meta['terms_per_wg'] "
        "(switchless) or net.meta['terms_per_grp'] (dragonfly); "
        f"neither is set (meta keys: {sorted(net.meta)})")


def _num_groups(net: Network) -> int:
    return net.meta["g"]


def hotspot(net: Network, num_hot: int = 4, seed: int = 0) -> TrafficPattern:
    """Communication confined to `num_hot` of the W-groups (Sec. V-A3b):
    sources in hot groups send to random terminals of the other hot groups.
    The returned pattern carries the hot-source `inject_mask`."""
    g = _num_groups(net)
    tpg = _terms_per_group(net)
    rng = np.random.default_rng(seed)
    hot = np.sort(rng.choice(g, size=min(num_hot, g), replace=False))
    hot_t = _per_device(hot)
    T = net.num_terminals
    src_wg = np.arange(T) // tpg

    def sample(key, t):
        ks = jr.split(key)
        wsel = jr.randint(ks[..., 0, :], (T,), 0, len(hot))
        off = jr.randint(ks[..., 1, :], (T,), 0, tpg)
        return hot_t(key.device)[wsel] * tpg + off

    return TrafficPattern(sample, np.isin(src_wg, hot))


def worst_case(net: Network) -> TrafficPattern:
    """Adversarial WC: node in W-group i sends to random node of W-group
    i+1 (Sec. V-A3b / Kim et al.)."""
    g = _num_groups(net)
    tpg = _terms_per_group(net)
    T = net.num_terminals
    src_wg = _per_device(np.arange(T) // tpg)

    def sample(key, t):
        off = jr.randint(key, (T,), 0, tpg)
        return ((src_wg(key.device) + 1) % g) * tpg + off

    return TrafficPattern(sample)


def ring_allreduce(net: Network, bidirectional: bool = False) -> TrafficPattern:
    """Ring AllReduce traffic (Sec. V-A3c): chip i sends to chip (i+1) mod C
    (uni) or alternates between (i-1) and (i+1) (bi), along the snake
    order of chips on the wafer; terminal j of chip i targets terminal j
    of the neighbouring chip."""
    T = net.num_terminals
    C = net.num_chips
    tpc = net.meta.get("terms_per_chip", 1)
    assert T == C * tpc
    order = net.tables.get("chip_ring_order", np.arange(C))
    ring_pos = np.empty(C, dtype=np.int64)
    ring_pos[order] = np.arange(C)  # chip -> position in ring
    chip = net.term_chip
    chip_terms = np.full((C, tpc), -1, dtype=np.int64)
    fill = np.zeros(C, dtype=np.int64)
    slot = np.zeros(T, dtype=np.int64)
    for t_ in range(T):
        c = chip[t_]
        slot[t_] = fill[c]
        chip_terms[c, fill[c]] = t_
        fill[c] += 1
    nxt_chip = order[(ring_pos[chip] + 1) % C]
    prv_chip = order[(ring_pos[chip] - 1) % C]
    nxt = chip_terms[nxt_chip, slot]
    prv = chip_terms[prv_chip, slot]

    if not bidirectional:
        return _perm_pattern(nxt)
    nxt_t, prv_t = _per_device(nxt), _per_device(prv)

    def sample(key, t):
        coin = jr.bernoulli(key, 0.5, (T,))
        return torch.where(coin, nxt_t(key.device), prv_t(key.device))

    return TrafficPattern(sample)


def batched(sample):
    """The batched-key form `sample_b(keys[B, 2], t) -> dest[B, T]`.  Port
    samplers are lane-batched already (leading key dimensions are lanes),
    so this only unwraps a `TrafficPattern`."""
    if isinstance(sample, TrafficPattern):
        sample = sample.sample
    return sample


def split_lanes(key, num_lanes: int):
    """Per-lane PRNG keys [B, 2] for a batched sweep."""
    return jr.split(key, num_lanes)


# By-name registry: factory(net, **params) -> TrafficPattern.
PATTERNS = {
    "uniform": uniform,
    "bit_reverse": bit_reverse,
    "bit_shuffle": bit_shuffle,
    "bit_transpose": bit_transpose,
    "worst_case": worst_case,
    "hotspot": hotspot,
    "ring_allreduce": ring_allreduce,
}


def validate_pattern_params(name: str, params: dict) -> None:
    """Raise ValueError for an unknown pattern name or parameters that do
    not bind to the factory's signature."""
    if name not in PATTERNS:
        raise ValueError(
            f"unknown traffic pattern {name!r}; registered: "
            f"{sorted(PATTERNS)}")
    try:
        inspect.signature(PATTERNS[name]).bind(None, **params)
    except TypeError as e:
        raise ValueError(f"bad params for pattern {name!r}: {e}") from None


def make_pattern(net: Network, name: str, **params) -> TrafficPattern:
    """Resolve a registered pattern by name (always a `TrafficPattern`
    pair, mask included)."""
    validate_pattern_params(name, params)
    return as_pattern(PATTERNS[name](net, **params))
