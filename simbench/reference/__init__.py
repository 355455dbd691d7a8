"""A plain PyTorch reference of the flit-level network simulator, the
yardstick that decides a benchmark run's `correct`.

    results = simulate(config, traffic, lanes, device="cuda")

`config` is a configuration file's object (``simbench/configs/*.json``:
the topology and the router microarchitecture, the cycle budget),
`traffic` a traffic file's (``simbench/traffic/*.json``: the pattern and
the routing), and `lanes` a list of (offered flits/cycle/chip, lane seed)
pairs.  Every lane's counters come back as a `SimResult`, in lane order.

The cycle is the oracle phase pipeline (inject -> arbitrate -> apply ->
stats), one eager step a cycle, with the plain two-pass grant: no CUDA
graph and no hand-written kernel.  The network, its routing tables, the
traffic sampler and the Threefry key chains are built here from the two
files and the seeds; this package imports torch and numpy only, and
nothing of the program it judges.

`rate_dtype` rounds each lane's per-terminal injection probability
through a narrower float before the float32 comparison: the control run
(``simbench/control.py``) passes ``torch.bfloat16``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import prng as jr
from .engine.state import build_lane, make_state
from .engine.stats import finalize, lane_stats
from .engine.step import key_chain, make_step, run_steps
from .result import SimConfig, SimResult
from .routing import share_lanes
from .topology import (Network, SwitchDragonflyParams, SwitchlessParams,
                       build_switch_dragonfly, build_switchless)
from .traffic import make_pattern

__all__ = ["SimConfig", "SimResult", "build_network", "sim_config",
           "simulate"]

_BUILDERS = {"switchless": (SwitchlessParams, build_switchless),
             "dragonfly": (SwitchDragonflyParams, build_switch_dragonfly)}


def build_network(config: dict) -> Network:
    """The configuration's network, from its ``topology`` object (``kind``
    and the builder's parameters)."""
    topo = dict(config["topology"])
    params, build = _BUILDERS[topo.pop("kind")]
    return build(params(**topo))


def sim_config(config: dict, traffic: dict) -> SimConfig:
    """The simulation settings of a (configuration, traffic) pair."""
    return SimConfig(
        pkt_len=config["pkt_len"], buf_pkts=config["buf_pkts"],
        srcq_pkts=config["srcq_pkts"],
        vcs_per_class=config["vcs_per_class"], vc_mode=config["vc_mode"],
        warmup=config["warmup"], measure=config["measure"],
        route_mode=traffic["route_mode"])


def simulate(config: dict, traffic: dict, lanes, *, device,
             rate_dtype=torch.float32) -> list:
    """Run the `lanes` (offered, seed) pairs together on `device` for the
    configuration's warmup + measure cycles; one `SimResult` a lane."""
    net = build_network(config)
    cfg = sim_config(config, traffic)
    pattern = make_pattern(net, traffic["pattern"],
                           **traffic.get("params", {}))
    step, consts = make_step(net, cfg, pattern, device=device)
    B = len(lanes)
    terms_per_chip = net.num_terminals / net.num_chips
    rates = []
    for offered, _ in lanes:
        rate = offered / cfg.pkt_len / terms_per_chip
        if rate > 1.0 + 1e-9:
            raise ValueError(f"offered {offered}/chip needs a per-terminal "
                             f"packet rate {rate:.2f} > 1")
        rates.append(rate)
    rate_pkt = torch.tensor(rates, dtype=torch.float32).to(rate_dtype).to(
        device=device, dtype=torch.float32)
    keys = torch.stack([jr.PRNGKey(int(s)) for _, s in lanes]).to(device)
    cycles = cfg.warmup + cfg.measure
    fl = share_lanes(build_lane(net, cfg, None, device=device), B)
    state = make_state(net, cfg, consts["NV"], batch=(B,), device=device)
    state = run_steps(step, key_chain(keys, cycles), cfg.warmup, state,
                      rate_pkt, fl)
    inject = (np.ones(net.num_terminals, dtype=bool)
              if pattern.inject_mask is None
              else np.asarray(pattern.inject_mask).astype(bool))
    chips = net.num_chips * inject.sum() / net.num_terminals
    return [finalize(lane_stats(state.stats, i), cfg, float(offered), chips)
            for i, (offered, _) in enumerate(lanes)]
