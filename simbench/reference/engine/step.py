"""One simulated cycle, wired from the phase modules:

    inject -> arbitrate (route + VC expansion + grant) -> apply -> stats

`make_step` returns `step(state, (t, key, rate_pkt, fl)) -> state` over a
state with a leading lane dimension ``B``: `key` is ``[B, 2]``, `rate_pkt`
``[B]`` float32, `t` a host int, and `fl` the lane-stacked fault data
(``[B, ...]``; shared lanes are stride-0 views, see `routing.share_lanes`).
`run_steps` advances the lanes one eager step a cycle.
"""
from __future__ import annotations

import torch

from .. import prng as jr
from ..topology import Network
from ..traffic import as_pattern
from .apply import make_apply_fn
from .arbitrate import make_arbitrate_fn
from .inject import make_inject_fn
from .state import build_consts, resolve_epoch
from .stats import accumulate, reap_mask, track_occ, zero_stats


def make_step(net: Network, cfg, pattern, *, device):
    """Returns (step, consts).  With epoch-stacked lanes
    (`FaultSchedule`s) the step first selects each lane's epoch in effect
    at cycle `t`."""
    pattern, inject_mask = as_pattern(pattern)
    consts, route_kernel = build_consts(net, cfg, device=device)
    inject = make_inject_fn(net, cfg, consts, pattern, inject_mask)
    arbitrate = make_arbitrate_fn(net, cfg, consts, route_kernel)
    apply_moves = make_apply_fn(net, cfg, consts)
    # router-death reaper (0 runs no reap logic at all)
    reap_age = int(cfg.reap_age)

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
        return state.replace(stats=stats)

    return step, consts


def key_chain(key: torch.Tensor, cycles: int) -> torch.Tensor:
    """The per-cycle subkeys ``[cycles, ..., 2]`` of the lanes `key
    [..., 2]`: ``key_{t+1}, sub_t = split(key_t)``, drawn on the CPU and
    moved to `key`'s device once."""
    k = key.cpu()
    subs = []
    for _ in range(cycles):
        s = jr.split(k)
        k = s[..., 0, :]
        subs.append(s[..., 1, :])
    return torch.stack(subs).to(key.device)


def run_steps(step, subs, reset_at: int, state, rate_pkt, fl):
    """Advance the lanes ``len(subs)`` steps from cycle 0, one host-int
    cycle a step; the stats are zeroed after cycle `reset_at` (the end of
    warmup)."""
    for t in range(int(subs.shape[0])):
        state = step(state, (t, subs[t], rate_pkt, fl))
        if t == reset_at:
            state = state.replace(stats=zero_stats(state.stats))
    return state
