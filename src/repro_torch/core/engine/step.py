"""One simulated cycle, wired from the phase modules:

    inject -> arbitrate (route + VC expansion + grant) -> apply -> stats

Port of `repro.core.engine.step`.  `make_step` returns
`step(state, (t, key, rate_pkt, fl)) -> (state, None)` over a state with a
leading lane dimension ``B``: `key` is ``[B, 2]``, `rate_pkt` ``[B]``
float32, and `fl` the lane-stacked fault data (``[B, ...]``; shared lanes
are stride-0 views, see `routing.share_lanes`).  `t`, the cycle index, is
a host int or a 0-d int32 tensor on the lanes' device; the step makes no
host synchronisation either way, so a CUDA graph captured with a tensor
`t` replays at any starting cycle.

Two cycle loops replace the reference's `lax.scan`: `run_steps`, one
step a host-int cycle with the warmup reset decided on the host (the
parity yardstick; `run_scan` from cycle 0), and `superstep_body`, K
cycles with `t` and the reset on the device — the body
`engine.graphs.CycleGraph` replays as a CUDA graph (and runs eagerly on
the CPU).  Both take the subkeys of `key_chain`, the one place the lanes'
per-cycle key chain is drawn.
"""
from __future__ import annotations

import torch

from ...kernels.netsim.ops import threefry_chain
from ...spans import span
from ..topology import Network
from ..traffic import as_pattern
from .apply import make_apply_fn
from .arbitrate import make_arbitrate_fn
from .fused import make_compact_step, make_fused_step
from .inject import make_inject_fn
from .state import (build_consts, resolve_device, resolve_epoch,
                    resolve_reap_age)
from .stats import (accumulate, reap_mask, reset_stats_where, track_occ,
                    zero_stats)

# the valid `cfg.step_impl` values (SimConfig validates against this):
# "jnp" is the phase pipeline below (the oracle), "fused" the per-channel
# winner restructuring and "compact" its occupancy-compacted form
# (`fused.py`; both bit-identical to the oracle)
STEP_IMPLS = ("jnp", "fused", "compact")


def make_step(net: Network, cfg, pattern, inject_mask=None, *, device=None):
    """Returns (step, consts); step(state, (t, key, rate_pkt, fl)) ->
    (state, None).

    With epoch-stacked lanes (`FaultSchedule`s) the step first selects
    each lane's epoch in effect at cycle `t`."""
    impl = getattr(cfg, "step_impl", "jnp")
    if impl == "fused":
        return make_fused_step(net, cfg, pattern, inject_mask, device=device)
    if impl == "compact":
        return make_compact_step(net, cfg, pattern, inject_mask,
                                 device=device)
    if impl != "jnp":
        raise ValueError(f"unknown step_impl {impl!r}; "
                         f"valid: {STEP_IMPLS}")
    device = resolve_device(device)
    pattern, inject_mask = as_pattern(pattern, inject_mask)
    consts, route_kernel = build_consts(net, cfg, device=device)
    inject = make_inject_fn(net, cfg, consts, pattern, inject_mask)
    arbitrate = make_arbitrate_fn(net, cfg, consts, route_kernel)
    apply_moves = make_apply_fn(net, cfg, consts)
    # router-death reaper (0 runs no reap logic at all)
    reap_age = resolve_reap_age(cfg)

    def step(state, t_key_rate_fl):
        t, key, rate_pkt, fl = t_key_rate_fl
        fl = resolve_epoch(fl, t)
        state = inject(state, t, key, rate_pkt, fl)
        stats = track_occ(state.stats, state)
        req, win, won_ch = arbitrate(state, t, fl)
        alive = fl["ch_alive"]
        reap = (reap_mask(req, t, reap_age, alive)
                if reap_age else None)
        stats = accumulate(stats, req, win, consts, t, reap=reap,
                           ch_alive=alive if reap_age else None)
        state = apply_moves(state, req, win, won_ch, t, reap=reap)
        return state.replace(stats=stats), None

    return step, consts


def key_chain(keys: torch.Tensor, cycles: int) -> tuple:
    """The per-cycle subkeys of the lanes `keys [..., 2]`:
    ``key_{t+1}, sub_t = split(key_t)``, returned as ``(next_keys,
    subs)``: the key after `cycles` splits and the subkeys ``[cycles, ...,
    2]``, both on `keys`' device.  A window of r cycles hands `next_keys`
    to the next one, so the windows replay the one-shot chain.  On a CUDA
    key the chain is one launch of the netsim library's Threefry kernel
    (`kernels.netsim.ops.threefry_chain`), issued without waiting; on a
    CPU key it is the plain chain, one split a cycle.  Both give the same
    bits.  The whole of it is the span `sweep.key_chain`."""
    with span("sweep.key_chain"):
        return threefry_chain(keys, cycles)


def run_steps(step, t0: int, subs, reset_at: int, state, rate_pkt, fl):
    """Advance the lanes ``len(subs)`` steps from absolute cycle `t0`,
    one host-int cycle a step; stats are zeroed after cycle `reset_at`
    (the end of warmup)."""
    for i in range(int(subs.shape[0])):
        t = t0 + i
        state, _ = step(state, (t, subs[i], rate_pkt, fl))
        if t == reset_at:
            state = state.replace(stats=zero_stats(state.stats))
    return state


def run_scan(step, cycles: int, reset_at: int, state0, rate_pkt, key, fl):
    """Advance the lanes `cycles` steps from cycle 0 (`run_steps`): `key`
    is ``[B, 2]``, and lane b draws the reference's per-cycle subkey
    chain of its key."""
    return run_steps(step, 0, key_chain(key, cycles)[1], reset_at, state0,
                     rate_pkt, fl)


def superstep_body(step, K: int):
    """K cycles of `step` as one function
    ``body(state, t0, subs, rate_pkt, fl, reset_at) -> state``: `t0` and
    `reset_at` are 0-d int32 tensors, `subs` the ``[K, B, 2]`` subkeys.
    Substep i runs at its own absolute cycle ``t0 + i`` and zeroes the
    stats on the device when that cycle is `reset_at`, so a warm-fault
    epoch onset or the end of warmup anywhere inside the superstep gives
    the counters of K = 1 (the reference's per-substep `cond`)."""

    def body(state, t0, subs, rate_pkt, fl, reset_at):
        for i in range(K):
            t = t0 + i if i else t0
            state, _ = step(state, (t, subs[i], rate_pkt, fl))
            state = state.replace(
                stats=reset_stats_where(state.stats, t == reset_at))
        return state

    return body
