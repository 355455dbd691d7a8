#!/usr/bin/env python3
"""Where the netsim kernels spend their time, on one NVIDIA GPU.

    python3 tools/netsim_phases.py     # from the repository root

Drives the main path's network (the paper's radix-16 g = 41 switch-less
wafer, 4 lanes) for a few cycles of the oracle, fused and compact steps
(`chip_smoke.py`'s live phases), keeps the last call's arguments of
`grant` and `cycle_core`, and at each of those shapes prints:

- the device time per call and the kernels per call (torch.profiler, 50
  calls) and the time per call of 200 back-to-back calls (CUDA events) of
  the three-pass kernel, and at the row-index shapes (oracle, fused) of the
  one-launch cooperative kernel ("coop", the one the wrappers run there);
  at the compact step's shape, "coop" on the same rows with the row-index
  priority, beside the three-pass kernel on the step's own; each held bit
  for bit to the plain version;
- the coop kernel's phases in its last call, from the global timer that
  thread 0 of the first 128 blocks reads at each boundary (built with
  ``NETSIM_PHASES``), mean and max over those blocks: the rows (stream,
  atomics, the next table set), the grid barrier and the channels;
- the atomics: rows that run one, and the share whose channel takes more
  than one (the atomics that contend);

then "coop" and the three-pass kernel's device time on random inputs at
the unit tests' sizes and at each registered paper network's shape (4
lanes, its request rows and channels; `sweep_shapes`).  The instrumented
variant is built from copies under ``build/netsim_phases/``; the
repository's sources are not touched.  The last line is JSON.  Exits
nonzero without a CUDA device.
"""
from __future__ import annotations

import ctypes
import json
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

COOP_PHASES = ("rows", "grid barrier", "channels")
MARKS, MARK_BLOCKS = 7, 128    # kMarks, kPhaseBlocks in arbiter.cuh
PAPER_NETWORKS = ("paper_radix16_switchless", "paper_radix16_dragonfly",
                  "paper_radix32_dragonfly", "paper_radix32_switchless")
_P, _I = ctypes.c_void_p, ctypes.c_int


def sweep_shapes():
    """(label, B, N, E) of the size sweep: two of the unit tests' sizes,
    then each registered paper network at 4 lanes with its request rows
    (`fused.compact_rows`) and channels."""
    from repro_torch.core import topology as T
    from repro_torch.core.engine.fused import compact_rows
    from repro_torch.core.simulator import SimConfig
    shapes = [("unit", 1, 1000, 301), ("unit", 4, 20012, 1029)]
    for name in PAPER_NETWORKS:
        p = getattr(T, name)()
        build = (T.build_switchless if isinstance(p, T.SwitchlessParams)
                 else T.build_switch_dragonfly)
        net = build(p, name)
        shapes.append((name, 4, compact_rows(net, SimConfig()),
                       net.num_channels))
    return shapes


def variant(out_dir: Path) -> list[Path]:
    """Copies of the netsim sources under `out_dir`, the skeleton opening
    with ``#define NETSIM_PHASES 1``."""
    from repro_torch.kernels.netsim import ops
    out_dir.mkdir(parents=True, exist_ok=True)
    csrc = ops.SOURCES[0].parent
    header = (csrc / "arbiter.cuh").read_text()
    (out_dir / "arbiter.cuh").write_text("#define NETSIM_PHASES 1\n" + header)
    for src in ops.SOURCES:
        shutil.copy(src, out_dir / src.name)
    return [out_dir / src.name for src in ops.SOURCES]


def device_us(fn, reps=50):
    """Device time per call (us) and kernels per call, from the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    attr = ("self_device_time_total"
            if hasattr(events[0], "self_device_time_total")
            else "self_cuda_time_total")
    kernels = [e for e in events if getattr(e, attr) > 0
               and e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(getattr(e, attr) for e in kernels) / reps,
            sum(e.count for e in kernels) / reps)


def marks(lib, kernel, blocks, phases):
    """{phase: {mean, max}} in ns over the first `blocks` marked blocks of
    the last call, and the time the last of them ended."""
    import torch
    raw = (ctypes.c_ulonglong * (MARK_BLOCKS * MARKS))()
    rc = getattr(lib, f"netsim_{kernel}_phase_read")(ctypes.addressof(raw))
    if rc != 0:
        raise RuntimeError(f"reading the phase marks: error {rc}")
    t = torch.tensor(list(raw), dtype=torch.float64).view(
        MARK_BLOCKS, MARKS)[:blocks, :len(phases) + 1]
    t = t - t[:, 0].min()
    dur = t[:, 1:] - t[:, :-1]
    return ({p: dict(mean=float(dur[:, i].mean()), max=float(dur[:, i].max()))
             for i, p in enumerate(phases)}, float(t[:, -1].max()))


def atomics(eligible, out, E):
    """(rows with an atomic, the share whose channel takes more than
    one)."""
    import torch
    B = out.shape[0]
    o = out.long().clamp(0, E - 1)
    counts = torch.zeros((B, E), dtype=torch.long, device=out.device)
    counts.scatter_add_(1, torch.where(eligible, o, 0), eligible.long())
    contend = eligible & (counts.gather(1, o) > 1)
    n = int(eligible.sum())
    return dict(rows=n, contended_share=int(contend.sum()) / max(n, 1))


def bind(phases_lib):
    for name in ("netsim_grant_phase_read", "netsim_cycle_core_phase_read"):
        getattr(phases_lib, name).argtypes = [_P]
        getattr(phases_lib, name).restype = _I


def instrumented(phases_lib, kernel, call):
    """`call()` with the wrapper's coop kernel taken from the instrumented
    build."""
    from repro_torch.kernels.netsim import ops
    name = f"netsim_{kernel}_coop"
    saved = ops._BOUND[ops.LIBRARY][name]
    ops._BOUND[ops.LIBRARY][name] = ops._BOUND["netsim_phases"][name]
    try:
        return call()
    finally:
        ops._BOUND[ops.LIBRARY][name] = saved


def main():
    import numpy as np
    import torch
    import chip_smoke as smoke
    from repro_torch.kernels import build
    from repro_torch.kernels.netsim import ops
    if not torch.cuda.is_available():
        print("netsim_phases: no CUDA device", file=sys.stderr)
        return 2
    card = smoke.card_line()
    print(f"[card] {card}")
    builds = ((ops.LIBRARY, ops.SOURCES),
              ("netsim_phases",
               variant(build.BUILD_DIR.parent / "netsim_phases")))
    with ThreadPoolExecutor() as pool:
        _, phases_lib = pool.map(lambda nb: ops.library(*nb), builds)
    bind(phases_lib)

    device = "cuda"
    net = smoke.full_width_net()
    _, grant_args, buf_pkts = smoke.phase_grant_live(net, device, cycles=20)
    shapes = [("oracle", "grant", grant_args, dict(buf_pkts=buf_pkts))]
    for impl in smoke.FAST_STEPS:
        _, (args, kw) = smoke.phase_cycle_core_live(net, device, impl,
                                                    cycles=20)
        shapes.append((impl, "cycle_core", args, kw))

    rows = []
    for label, kernel, args, kw in shapes:
        fn, ref = ((ops.grant, ops.grant_ref) if kernel == "grant"
                   else (ops.cycle_core, ops.cycle_core_ref))
        B, N = args[0].shape
        E = args[5 if kernel == "grant" else 3].shape[-1]
        row = dict(shape=label, kernel=kernel, B=B, N=N, E=E)
        # (call, the plain version's result) for each kernel
        calls = {"three_pass": (lambda: fn(*args, **kw, kernel="three_pass"),
                                ref(*args, **kw))}
        explicit = kw.get("prio") is not None
        if explicit:
            # the compact step's rows with the row-index priority: the coop
            # kernel takes no explicit priority
            kw_rows = dict(kw, prio=None, r2=1 << (N - 1).bit_length())
            calls["coop at the row index"] = (
                lambda: fn(*args, **kw_rows, kernel="coop"),
                ref(*args, **kw_rows))
        else:
            calls["coop"] = (lambda: fn(*args, **kw, kernel="coop"),
                             calls["three_pass"][1])
        for name, (call, want) in calls.items():
            got = call()
            torch.cuda.synchronize()
            smoke.check(all(torch.equal(a, b) for a, b in zip(got, want)),
                        f"{label} {name} != plain version")
            dev, per_call = device_us(call)
            row[name] = dict(device_us=dev, kernels_per_call=per_call,
                             wall_us=smoke.cuda_ms(call, 200) * 1e3)
        print(f"[netsim_phases] {label} ({kernel}) B={B} N={N} E={E}: "
              + "; ".join(f"{k} {row[k]['device_us']:.2f} us device "
                          f"({row[k]['kernels_per_call']:.0f} kernels), "
                          f"{row[k]['wall_us']:.2f} us wall" for k in calls))
        if not explicit:
            call, want = calls["coop"]
            got = instrumented(phases_lib, kernel, call)
            torch.cuda.synchronize()
            smoke.check(all(torch.equal(a, b) for a, b in zip(got, want)),
                        f"{label} instrumented coop kernel != plain version")
            row["coop_phases_ns"], row["coop_span_ns"] = marks(
                phases_lib, kernel, MARK_BLOCKS, COOP_PHASES)
            if kernel == "grant":
                out_, _, valid, ovc, eject = args[:5]
                eligible = valid & ((ovc < kw["buf_pkts"]) | eject)
            else:
                out_, eligible = args[0], args[2]
            eligible = eligible & (out_ >= 0) & (out_ < E)
            row["atomics"] = a = atomics(eligible, out_, E)
            print(f"[netsim_phases]   coop phases (ns, thread 0 of the "
                  f"first blocks, mean / max): " + "; ".join(
                      f"{p} {v['mean']:.0f} / {v['max']:.0f}"
                      for p, v in row["coop_phases_ns"].items())
                  + f"; the last ends at {row['coop_span_ns']:.0f} ns")
            print(f"[netsim_phases]   atomics: {a['rows']} rows, "
                  f"{100 * a['contended_share']:.1f}% on a channel with "
                  f"another")
        rows.append(row)

    sweep = []
    rng = np.random.default_rng(0)
    for label, B, N, E in sweep_shapes():
        gargs = smoke._random_grant_inputs(rng, B, N, E, device)
        cargs, prio, r2 = smoke._random_cycle_inputs(rng, B, N, E, 0, False,
                                                     device)
        entry = dict(shape=label, B=B, N=N, E=E)
        for k in ops.KERNELS:
            entry[f"grant_{k}_us"] = device_us(
                lambda: ops.grant(*gargs, buf_pkts=8, kernel=k))[0]
            entry[f"cycle_core_{k}_us"] = device_us(
                lambda: ops.cycle_core(*cargs, r2=r2, kernel=k))[0]
        print(f"[netsim_phases] sweep {label} B={B} N={N} E={E}: device "
              f"us a call "
              + ", ".join(f"{k[:-3]} {v:.2f}" for k, v in entry.items()
                          if k.endswith("_us")))
        sweep.append(entry)
    print(card)
    print(json.dumps({"card": card, "shapes": rows, "sweep": sweep}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
