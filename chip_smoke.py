#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py              # from the repository root
    python3 chip_smoke.py --profile    # adds a torch.profiler window

Phases (any failure ends the run with a nonzero exit):

1. the card (nvidia-smi name and power limit, torch and CUDA versions) and
   the build of every CUDA kernel of the path from this checkout's sources;
2. the PRNG on the card: Threefry-2x32 known answers, and split / uniform /
   randint / bernoulli on CUDA equal to the same calls on the CPU;
3. the grant kernel against its plain PyTorch version on the card, bit for
   bit: (a) random inputs with stranded rows and ties, (b) the live engine
   states of the first cycles of phase 4's run;
4. the main path: `Simulator.sweep_grid` on the paper's radix-16
   evaluation network (g = 41: 1,312 chips, 30,176 channels) at 2 rates x
   2 seeds = 4 lanes, with the grant launch count, exact packet
   conservation on every lane, and accepted = offered load at 0.1;
5. the port on the card against the port on the CPU on a small network,
   field for field, across routing modes, cold and warm faults and the
   reaper.

Then one JSON line of kernel numbers, the card's name and power limit, and
the final status line.  Exits nonzero, printing no result, without a CUDA
device or without the repository's sources.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

H100_BYTES_PER_S = 3.35e12      # HBM3 of the H100 SXM (NVIDIA data sheet)
FULL_RATES, FULL_SEEDS = (0.1, 0.4), (0, 1)
FULL_CFG = dict(warmup=300, measure=1200)
LIVE_CYCLES = 50


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean time of `fn()` per call on the card (CUDA events, warmed up)."""
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_build():
    from repro_torch.kernels import build
    from repro_torch.kernels.netsim import ops
    t0 = time.perf_counter()
    ops.library()
    rec = build.build_record(ops.LIBRARY)
    print(f"[build] netsim grant kernel: nvcc {rec['seconds']:.2f} s "
          f"(load {time.perf_counter() - t0:.2f} s)")
    for line in rec["report"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build]   {line.strip()}")


def phase_prng(device):
    import torch
    from repro_torch import random as jr
    M = 0xFFFFFFFF
    kats = [((0, 0), (0, 0), (0x6b200159, 0x99ba4efe)),
            ((M, M), (M, M), (0x1cb996fc, 0xbb002be7)),
            ((0x13198a2e, 0x03707344), (0x243f6a88, 0x85a308d3),
             (0xc4923a9c, 0x483df7a0))]
    for key, count, want in kats:
        got = jr.threefry2x32(*(torch.tensor(v, dtype=torch.int64,
                                             device=device)
                                for v in (*key, *count)))
        check(tuple(int(v) for v in got) == want, f"threefry KAT {key}")
    keys = torch.stack([jr.PRNGKey(s) for s in (0, 1, 2, 3)])
    draws = [lambda k: jr.split(k, 3),
             lambda k: jr.uniform(k, (5248,)),
             lambda k: jr.randint(k, (5248,), 0, 5247),
             lambda k: jr.randint(k, (5248,), 0, 41),
             lambda k: jr.bernoulli(k, 0.5, (5248,))]
    for i, f in enumerate(draws):
        a, b = f(keys.to(device)).cpu(), f(keys)
        check(torch.equal(a, b), f"PRNG draw {i}: CUDA != CPU")
    print("[prng] threefry known answers and split/uniform/randint/"
          "bernoulli: CUDA == CPU, bit for bit")


def _random_grant_inputs(rng, B, N, E, device):
    import torch
    cols = [rng.integers(-1, E, (B, N)).astype(np.int32),
            rng.integers(0, 4, (B, N)).astype(np.int32),
            rng.random((B, N)) < 0.8,
            rng.integers(0, 10, (B, N)).astype(np.int32),
            rng.random((B, N)) < 0.2,
            (rng.integers(0, 3, (B, E))
             * (rng.random((B, E)) < 0.3)).astype(np.int32),
            rng.random((B, E)) < 0.9]
    return [torch.as_tensor(c).to(device) for c in cols]


def _grant_err(args, buf_pkts):
    """Max |kernel - plain| over both outputs (as integers)."""
    from repro_torch.kernels.netsim import grant, grant_ref
    got = grant(*args, buf_pkts=buf_pkts)
    want = grant_ref(*args, buf_pkts=buf_pkts)
    return max(int((g.int() - w.int()).abs().max()) for g, w in
               zip(got, want))


def phase_grant_random(device):
    rng = np.random.default_rng(0)
    err = 0
    for B, N, E in [(1, 1, 1), (1, 4099, 291), (4, 204673, 30177),
                    (1, 100003, 1029)]:
        err = max(err, _grant_err(_random_grant_inputs(rng, B, N, E, device),
                                  8))
    check(err == 0, f"grant kernel != grant_ref on random inputs ({err})")
    print("[grant] random inputs (B in {1,4}, E in {1,291,30177,1029}): "
          "kernel == grant_ref")
    return err


def full_width_net():
    from repro_torch.core import topology as T
    return T.build_switchless(T.paper_radix16_switchless(), "radix16-g41")


def phase_grant_live(net, device, cycles=LIVE_CYCLES):
    """Kernel vs plain version on the live states of the first `cycles`
    cycles of the main path's lanes; returns (max error, the last cycle's
    grant inputs, buf_pkts)."""
    import torch
    from repro_torch import random as jr
    from repro_torch.core import traffic
    from repro_torch.core.engine import (build_consts, build_lane,
                                         make_apply_fn, make_inject_fn,
                                         make_state)
    from repro_torch.core.engine.arbitrate import expand_vcs, gather_requests
    from repro_torch.core.engine.step import _key_chain
    from repro_torch.core.engine.sweep import offered_to_rate_pkt
    from repro_torch.core.routing import share_lanes
    from repro_torch.core.simulator import SimConfig
    from repro_torch.core.topology import EJECT
    from repro_torch.kernels.netsim import grant, grant_ref
    cfg = SimConfig(**FULL_CFG)
    consts, route_kernel = build_consts(net, cfg, device=device)
    inject = make_inject_fn(net, cfg, consts, traffic.uniform(net))
    apply_moves = make_apply_fn(net, cfg, consts)
    lanes = [(r, s) for r in FULL_RATES for s in FULL_SEEDS]
    B = len(lanes)
    tpc = net.num_terminals / net.num_chips
    rates = torch.tensor([offered_to_rate_pkt(r, cfg, tpc) for r, _ in lanes],
                         dtype=torch.float32, device=device)
    subs = _key_chain(torch.stack([jr.PRNGKey(s) for _, s in lanes]),
                      cycles).to(device)
    fl = share_lanes(build_lane(net, cfg, None, device=device), B)
    state = make_state(net, cfg, consts["NV"], batch=(B,), device=device)
    err, granted = 0, 0
    for t in range(cycles):
        state = inject(state, t, subs[t], rates, fl)
        req = expand_vcs(gather_requests(state, consts, route_kernel, fl, t),
                         state, cfg)
        args = (req.out, req.itime, req.valid, req.ovc_count,
                req.otype == EJECT, state.ch_busy, fl["ch_alive"])
        win, won = grant(*args, buf_pkts=cfg.buf_pkts)
        rwin, rwon = grant_ref(*args, buf_pkts=cfg.buf_pkts)
        err = max(err, int((win.int() - rwin.int()).abs().max()),
                  int((won.int() - rwon.int()).abs().max()))
        granted += int(win.sum())
        state = apply_moves(state, req, win, won, t)
    check(err == 0, f"grant kernel != grant_ref on live states ({err})")
    check(granted > 0, "live states granted nothing")
    print(f"[grant] live full-width states, {cycles} cycles x {B} lanes "
          f"(N = {args[0].shape[1]} rows, E = {args[5].shape[1]} channels, "
          f"{granted} grants): kernel == grant_ref")
    return err, args, cfg.buf_pkts


def grant_bytes(args) -> int:
    """Bytes the grant must move: each input read once (a mask shared by
    every lane once), each output (win per row, won per channel, 1 byte)
    written once."""
    total = 0
    for x in args:
        x = x[0] if x.stride(0) == 0 else x
        total += x.numel() * x.element_size()
    return total + args[0].numel() + args[5].numel()


def phase_grant_timing(args, buf_pkts):
    from repro_torch.kernels.netsim import grant, grant_ref
    ms = cuda_ms(lambda: grant(*args, buf_pkts=buf_pkts), 200)
    plain_ms = cuda_ms(lambda: grant_ref(*args, buf_pkts=buf_pkts), 50)
    nbytes = grant_bytes(args)
    bound_ms = nbytes / H100_BYTES_PER_S * 1e3
    print(f"[grant] full width B={args[0].shape[0]}: kernel {ms * 1e3:.2f} "
          f"us/launch, plain {plain_ms * 1e3:.2f} us, bound "
          f"{bound_ms * 1e3:.2f} us ({nbytes} bytes at 3.35 TB/s)")
    return ms, plain_ms, bound_ms


class ConservationProbe:
    """Wraps a step and records each lane's in-flight packets right after
    the warmup cycle and after the last cycle, so measured counters can be
    held to ``generated == delivered + dropped + reaped + in-flight``."""

    def __init__(self, step, warmup, last):
        self.step, self.warmup, self.last = step, warmup, last
        self.inflight = {}

    def __call__(self, state, t_key_rate_fl):
        state, aux = self.step(state, t_key_rate_fl)
        t = t_key_rate_fl[0]
        if t in (self.warmup, self.last):
            self.inflight[t] = (state.b_count.sum((1, 2))
                                + state.s_count.sum(1)).cpu()
        return state, aux


def phase_main_path(net, device):
    import torch
    from repro_torch.core import traffic
    from repro_torch.core.simulator import SimConfig, Simulator
    from repro_torch.kernels.netsim import ops
    cfg = SimConfig(**FULL_CFG)
    cycles = cfg.warmup + cfg.measure
    t0 = time.perf_counter()
    sim = Simulator(net, cfg, traffic.uniform(net), device=device)
    probe = ConservationProbe(sim._batched.step, cfg.warmup, cycles - 1)
    sim._batched.step = probe
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    ops.grant.launches = 0
    t0 = time.perf_counter()
    grid = sim.sweep_grid(list(FULL_RATES), seeds=FULL_SEEDS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.grant.launches
    lanes = len(FULL_RATES) * len(FULL_SEEDS)
    print(f"[main] radix-16 g=41: {net.num_chips} chips, "
          f"{net.num_channels} channels, {lanes} lanes x {cycles} cycles "
          f"(set-up {setup_s:.2f} s)")
    grown = probe.inflight[cycles - 1] - probe.inflight[cfg.warmup]
    for i, r in enumerate(grid.flat()):
        print(f"[main]   offered {r.offered_per_chip:.2f} seed "
              f"{FULL_SEEDS[i % len(FULL_SEEDS)]}: throughput "
              f"{r.throughput_per_chip:.6f} latency {r.avg_latency:.4f} "
              f"delivered {r.delivered_pkts} generated {r.generated_pkts} "
              f"dropped {r.dropped_pkts} reaped {r.reaped_pkts} stranded "
              f"{r.stranded_pkts} in-flight {int(probe.inflight[cycles - 1][i])}")
        check(r.generated_pkts == r.delivered_pkts + r.dropped_pkts
              + r.reaped_pkts + int(grown[i]),
              f"conservation on lane {i}")
        if r.offered_per_chip == 0.1:
            check(abs(r.throughput_per_chip - 0.1) <= 0.005,
                  f"accepted {r.throughput_per_chip} != offered 0.1")
    check(launches == cycles,
          f"grant launches {launches} != cycles run {cycles}")
    print(f"[main] wall {wall:.3f} s: {cycles / wall:.2f} cycles/s, "
          f"{lanes * cycles / wall:.2f} lane-cycles/s; grant launches "
          f"{launches}; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} bytes")
    return launches


def phase_profile(net, device, cycles=20):
    """torch.profiler over a short steady window of the main path's step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import random as jr
    from repro_torch.core import traffic
    from repro_torch.core.engine import build_lane, make_state, make_step
    from repro_torch.core.engine.step import run_scan
    from repro_torch.core.routing import share_lanes
    from repro_torch.core.simulator import SimConfig
    cfg = SimConfig(**FULL_CFG)
    step, consts = make_step(net, cfg, traffic.uniform(net), device=device)
    B = len(FULL_RATES) * len(FULL_SEEDS)
    fl = share_lanes(build_lane(net, cfg, None, device=device), B)
    state = make_state(net, cfg, consts["NV"], batch=(B,), device=device)
    keys = torch.stack([jr.PRNGKey(s) for s in range(B)]).to(device)
    rates = torch.full((B,), 0.025, dtype=torch.float32, device=device)
    state = run_scan(step, 100, -1, state, rates, keys, fl)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_scan(step, cycles, -1, state, rates, keys, fl)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    attr = ("self_device_time_total"
            if hasattr(events[0], "self_device_time_total")
            else "self_cuda_time_total")
    kernels = [e for e in events if getattr(e, attr) > 0
               and e.device_type == torch.autograd.DeviceType.CUDA]
    dev = sum(getattr(e, attr) for e in kernels) / 1e3            # ms
    print(f"[profile] {cycles} cycles: wall {wall * 1e3:.1f} ms, device "
          f"busy {dev:.1f} ms ({100 * dev / (wall * 1e3):.1f}%), "
          f"{sum(e.count for e in kernels) / cycles:.0f} kernels per cycle")
    for e in kernels:
        if "grant" in e.key:
            print(f"[profile]   {e.key}: {getattr(e, attr) / e.count:.2f} us "
                  f"device time per launch, {e.count} launches")
    print(events.table(sort_by=attr, row_limit=20))


SMALL = dict(a=2, b=2, m=2, n=4, noc=2, g=3)


def phase_small_parity(device):
    """The port on `device` against the port on the CPU, field for field."""
    from repro_torch.core import topology as T
    from repro_torch.core import traffic
    from repro_torch.core.simulator import SimConfig, Simulator
    net = T.build_switchless(T.SwitchlessParams(**SMALL), "small")
    cyc = dict(warmup=50, measure=200)
    rng = np.random.default_rng(7)
    f = T.sample_link_faults(net, 0.08, rng, vc_mode="updown_merged")
    dead = T.sample_router_faults(net, 2, rng, vc_mode="updown")
    cases = [
        ("baseline/min", dict(), lambda s: s.sweep_grid([0.3, 1.2], (0, 1))),
        ("updown/ugal", dict(vc_mode="updown", route_mode="ugal"),
         lambda s: s.sweep_grid([0.3, 1.2], (0, 1))),
        ("updown_merged/val_restricted cold+warm",
         dict(vc_mode="updown_merged", route_mode="val_restricted"),
         lambda s: s.sweep_faults(0.8, [T.FaultSet(), f, T.FaultSchedule(
             ((0, T.FaultSet()), (120, f)))], (0, 1))),
        ("updown/min warm router death, reaper on",
         dict(vc_mode="updown", reap_age=20),
         lambda s: s.sweep_faults(0.8, [T.FaultSchedule(
             ((0, T.FaultSet()), (60, dead)))], (0, 1))),
    ]
    for name, over, run in cases:
        cfg = SimConfig(**cyc, **over)
        got = [run(Simulator(net, cfg, traffic.uniform(net), device=d))
               for d in (device, "cpu")]
        a, b = ([dataclasses.asdict(r) for r in g.flat()] for g in got)
        check(a == b, f"small-net parity {name}: CUDA != CPU")
        print(f"[parity] {name}: {len(a)} lanes, CUDA == CPU "
              f"(delivered {[r['delivered_pkts'] for r in a]})")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace a short window with torch.profiler")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    device = "cuda"
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}")
    phase_build()
    phase_prng(device)
    err = phase_grant_random(device)
    net = full_width_net()
    live_err, grant_args, buf_pkts = phase_grant_live(net, device)
    ms, plain_ms, bound_ms = phase_grant_timing(grant_args, buf_pkts)
    del grant_args
    launches = phase_main_path(net, device)
    if args.profile:
        phase_profile(net, device)
    phase_small_parity(device)
    print(json.dumps({"kernels": [{
        "name": "netsim.grant", "route": "cuda",
        "source": "src/repro_torch/kernels/netsim/csrc/grant.cu",
        "replaces": "src/repro/kernels/netsim/kernel.py:62",
        "launches": launches, "max_abs_err": max(err, live_err),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes", "library_ms": None}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
