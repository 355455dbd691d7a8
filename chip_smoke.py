#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py              # from the repository root
    python3 chip_smoke.py --profile    # adds torch.profiler windows

Phases (any failure ends the run with a nonzero exit):

1. the card (nvidia-smi name and power limit, torch and CUDA versions) and
   the build of every CUDA kernel of the path from this checkout's sources,
   with HGMMA instructions in the flash and the SSD libraries' SASS and the
   atomic opcodes of each netsim kernel;
2. the PRNG on the card: Threefry-2x32 known answers, and split / bits /
   uniform / randint / bernoulli on CUDA keys (the `threefry` kernel, one
   launch a draw, counted on the device), from one key, 4 lanes and the
   strided views of a split, equal to the same calls on the CPU (the
   plain versions);
3. each kernel against its plain PyTorch version on the card, bit for bit,
   and its time at the main path's shapes; the netsim wrappers' two
   kernels each (the one-launch cooperative kernel, row-index priority
   only, and the three-pass kernel), on the same inputs:
   - grant: (a) random inputs with stranded rows and ties, one at the
     radix-32 network's channel count, (b) the live engine states of the first cycles of
     phase 4's run, (c) timing at the oracle step's shape;
   - cycle_core: (a) random inputs (lanes, stranded rows, ties, an
     explicit priority, ages where the reference's int32 key overflows —
     there held to the two-pass `fused._grant` too, one at the radix-32
     network's channel count), (b) the live states of the first cycles of phase
     4's fused and compact runs, (c) timing at both steps' shapes;
   - head_records: the fused step's record gathers (dense and picked) at
     the benchmark's radix-16 switch-less shape (24 lanes), bit for bit
     against the `take` expressions they replace, and timed beside them
     and against their byte bounds (a `[head_records]` line);
   - threefry: each draw of the PRNG at the benchmark's radix-16
     switch-less shape (24 lanes x 5,248 terminals), bit for bit against
     the plain version on the card, timed (a launch eager and inside a
     CUDA graph) beside the plain version in a graph and against its
     bound, the larger of its bytes at 3.35 TB/s and its int32 operations
     at the card's rate (a `[threefry]` line);
4. the main path on the paper's radix-16 evaluation network (g = 41:
   1,312 chips, 30,176 channels), 2 rates x 2 seeds = 4 lanes through
   `Simulator.sweep_grid`, its cycles replayed as captured CUDA graphs,
   once per cycle step:
   - the oracle (`step_impl="jnp"`) at offered 0.1 and 0.4, with accepted
     = offered load at 0.1;
   - the fused and the compact step at offered 0.4 and 1.0 (Fig. 11's
     uniform-traffic loads), equal to each other on every lane and to the
     oracle on the 0.4 lanes;
   each with its kernel launch counts as the kernels count them on the
   card (one a cycle of every run plus the warm-up superstep of each
   capture, every one on the kernel that `kernel_for` names for the
   step's priority: the coop kernel for the oracle and fused steps, the
   three-pass kernel for the compact step's explicit priority; the
   wrappers' host counts tick only at each capture's warm-up and
   recording; the fused step's record gathers, `head_records`, one dense
   and one picked launch a cycle; the PRNG's draws, `threefry`, one
   split, one uniform and one randint launch a cycle in every step),
   exact packet conservation on every
   lane, and the memory the process holds with the three steps' graphs
   cached;
5. the port on the card against the port on the CPU on a small network,
   field for field, for all three steps across routing modes, cold and
   warm faults and the reaper, plus a compact run pinned below its live
   peak, which must escalate;
6. the cycle loop as captured CUDA graphs (the default on the card, and
   phase 4's loop) against the eager loop, field for field, for all three
   steps: on the small network at K = 4 with a warm onset (cycle 61) and
   the warmup reset (62) inside a superstep, cold faults and the reaper;
   on the paper network (4 lanes, 300 cycles) at K = 1 and 4, with a
   second sweep that must capture nothing, and cycles/s eager and replayed,
   capture seconds and peak memory; the lockstep and sequential lane forms
   timed (equal counters) beside the planner's pick; and
   `assert_deadlock_free` on the card equal to the CPU on the radix-16
   network with 7 W-groups;
7. the flash-attention kernels against their plain version on the card,
   each case on the kernel the (dtype, head_dim) rule names (bf16 at hd
   64, 128 and 256 on the tensor-core kernel, the rest on the FMA
   kernel): the shapes of the reference's kernel tests in fp32 and bf16,
   windows 32 and 128, non-causal with Sk = 96 and with a ragged Sk, the
   tensor-core kernel's edges in bf16 (Sq, Sk off its tiles, GQA with 3
   groups, MQA, windows 100 and 2048, non-causal Sq != Sk), head dim 96
   (zero-padded to 128) in fp32 and bf16, and the serving path's prefill
   shape (B = 4, S = 2048, H = 24, KV = 8,
   hd = 128) in fp32 and bf16, each output row held to its own size; the
   bf16 serving shape is also timed beside the FMA kernel on the same
   inputs, the plain version and the SDPA call; the recurrentgemma-2b
   prefill's local attention (B = 4, S = 4096, H = 10, KV = 1, hd = 256,
   window 2048, bf16) is checked and timed the same way, beside SDPA with
   the window as a mask, and so are deepseek-moe-16b's (B = 4, S = 2048,
   H = KV = 16, hd = 128), phi-3-vision-4.2b's (576 prefix rows + 2,048
   tokens: S = 2,624, off the kernel's 128-row tiles, H = KV = 32, hd = 96
   zero-padded to 128; SDPA at hd 96, the FMA kernel not timed) and
   seamless-m4t-medium's encoder (non-causal, beside plain SDPA) and
   decoder (B = 4, S = 2048, H = KV = 16, hd = 64);
8. the SSD scan kernels against their plain version `ssd_ref` on the
   card, each case on the kernel the (dtype, P, N) rule names (bf16 on the
   tensor-core kernel, fp32 on the FMA kernel): the shapes of the
   reference's kernel tests (property sweep and chunk invariance) in fp32,
   the tensor-core kernel's edges in bf16 (ragged S, P 16 and 32, N off its
   64 columns, the strided views of one conv output that `ssm_apply`
   passes), and the mamba2-780m prefill's shape (B = 4, S = 2048, H = 48,
   P = 64, N = 128) in fp32, bf16 and bf16 views; y and the final state
   held to 1e-4 in fp32, y to 2e-2 per output row and the state to 1e-4
   in bf16; the bf16 serving shape is timed beside the FMA kernel on the
   same inputs;
9. the RG-LRU scan kernels on the card, each case on the ring kernel that
   the rule names, held bit for bit to the direct kernel on the same
   inputs and at 1e-5 to `rglru_scan_ref`: the shapes of the reference's
   kernel tests (with S = 2048 at a = 0.999), R off the ring's 32 channels
   (37, 100), S off its 16-step stage (1, 37, 300), B 1 and 4, a base off
   16 bytes, and the recurrentgemma-2b prefill's (B = 4, S = 4096,
   R = 2560); the serving shape is timed, the ring kernel beside the
   direct one;
10. the LM serving path at full width, each model in bf16 with seeded
   random weights, `generate` with batch 4 and 16 new tokens, prefill on
   the kernels, timed over 5 samples (median and range of prefill ms and
   decode ms/token): `llama3.2-3b` (prompt 2048; one flash_attention launch
   a layer), `mamba2-780m` (prompt 2048; one ssd_scan launch a layer) and
   `recurrentgemma-2b` (prompt 4096, twice its window; one rglru launch a
   recurrent layer, one flash_attention launch a local layer), every
   flash_attention and ssd_scan launch on its tensor-core kernel and every
   rglru launch on the ring kernel; each then
   runs a kernel prefill and one decode step against the same cache,
   their last-position logits held to one naive forward over the prompt
   and that token: 2e-2 in bf16 (with SSM layers, or twice the naive
   forward's own move under a halved SSD chunk if larger), and for the
   two recurrent models also in fp32 at 1e-3;
11. the served smoke models (phases 10 and 17) in fp32 on the card
   against the CPU, with the serve command line's inputs: equal greedy
   tokens, prefill logits within 1e-4;
12. the experiment layer on the card: Fig. 11's grid at paper scale
   (`fig11_spec(fast=False)`: radix-16 g = 41 switch-less 1B and 2B and
   the switch-based Dragonfly, uniform and bit-reverse, offered 0.4 / 0.7
   / 1.0, 6 cells of 3 lanes), its cycles cut from 2,000 + 8,000 to 300 +
   1,200 through a spec JSON under `build/exp/`, run through
   `repro_torch.exp.run.main` and then again: one CUDA-graph capture a
   grid, then none; packet conservation on every lane; the switch-less 1B
   uniform cell equal, lane for lane, to `Simulator.sweep_grid`; per cell
   cycles/s and capture seconds, and the memory held with the cells'
   graphs cached; then `smoke`, `smoke_fused`, `smoke_compact`,
   `smoke_faults` and `smoke_warm_faults` on the card equal to the CPU,
   row for row (so the path runs both `cycle_core` kernels too);
13. windowed sessions and the service on the card: the fig11 1B uniform
   cell as a `LaneSession` at window 128, at K = 1 and 4, equal to the
   one-shot grid, and at K = 1 an `export()` after window 5 restored into
   a fresh session, equal too (windowed cycles/s beside the one-shot's);
   a `SimService` with `smoke` (alice, bob), `smoke_faults` (carol) and
   `smoke_warm_faults` (dave) at window 100, killed after 2 rounds and
   resumed from its snapshot: the uninterrupted run's JSONL byte for
   byte, the CPU run's lines after the meta line, captures == buckets;
14. the static analysis on the card: `repro_torch.analysis.check.main`
   with `--all --lint --serve` (spec, compile, capacity and step passes,
   the serve pass and the lint; report under `build/analysis/`) exits 0
   with all six passes run, each pass timed; the step pass's 27 cells
   launch `grant` (the coop kernel) on its 9 `jnp` cells and
   `cycle_core` on its 9 `fused` (coop) and 9 `compact` (three-pass)
   cells, once each, as the kernels count them on the card, and give the
   rule ids and locations the same pass gives on the CPU (each cell's
   operation count printed); each cell run again on the card and on the
   CPU, for its one cycle and for its 16-cycle warmup + measure, gives
   every state leaf bitwise equal; the compile pass on phase 12's spec JSON
   predicts the captures phase 12's first run made, and the serve pass
   at phase 13's window the captures of phase 13's service;
15. training on the card: the LM kernels' wrappers refuse autograd (a
   forward-only kernel's output has no grad_fn) and run under no_grad;
   (a) 3 train steps (fp32, chunked attention, remat, microbatch 2, weight
   decay 0.1) of the smoke minicpm-2b, deepseek-moe-16b (bf16 and int8
   dispatch), mamba2-780m and recurrentgemma-2b on the card and on the CPU
   from the same weights: metrics at 1e-5, parameters and moments as
   `phase_train_parity` states; (b) the reference's failure-injection run
   on the card (bf16 smoke, failures at steps 6 and 13): two restarts,
   step 20, then a snapshot restored bit for bit, bf16 leaves included;
   (c) minicpm-2b at full width through `repro_torch.launch.train.main`
   (batch 8, seq 128, 6 steps, chunked attention with remat, the WSD
   schedule): finite losses, the last nll below the first; step time,
   tokens/s, peak memory, and one step under torch.profiler;
16. deepseek-moe-16b served at full width as in phase 10 (prompt 2,048;
   28 flash_attention launches a prefill, all on the tensor-core kernel),
   the share of (token, slot) pairs the capacity dropped in a prefill,
   and the logits check run with no pair dropped (C = T), since the
   capacity depends on the token count of each call;
17. phi-3-vision-4.2b (576 `prefix_embeds` rows before a 2,048-token
   prompt, in the cache; 32 flash_attention launches a prefill) and
   seamless-m4t-medium (2,048 `src_embeds` frames encoded by 12
   non-causal layers, 12 causal decoder layers with a naive
   cross-attention each: 24 launches a prefill; every decode step
   re-encodes the source, naive, as the reference's serve loop does)
   served at full width as in phase 10, every flash launch on the
   tensor-core kernel, with the parameter count read from the module;
   the logits check in bf16 (2e-2) and over the whole model in fp32
   (1e-3);
18. the sharded step and the dry-run (no TPU kernel's counterpart runs
   here: chunked attention, and the kernels refuse autograd): (a) an
   NCCL process group of one rank (a `FileStore` under `build/`),
   `make_host_mesh(model=1)`, and minicpm-2b at full width through
   `Trainer(..., mesh=...)` at the launcher's batch 8 x 128, 3 steps,
   held to the plain `Trainer` on the same weights and batches (run first,
   its parameters moved to the host): metrics 1e-5 relative, parameters
   1e-5 absolute; both steps' median times side by side (DTensor's host
   cost), peak memory and kernels a step; (b) `lower_cell` for the same
   model, batch and a (1, 1) mesh on `cuda` fake tensors, held to the real
   sharded step: argument bytes equal to the real params, state and
   batch, predicted peak (argument + temp) within 10 % of step 2's
   `max_memory_allocated`, FLOPs within 0.1 % of `FlopCounterMode` over a
   real step; (c) the production-mesh cells of `DRYRUN_CELLS` at 256 and
   512 ranks (a fake process group): each `ok` with FLOPs and temp bytes
   above 0 and 256 / 512 chips, or skipped where `cell_applicable` says
   so; the multi-pod train cells move bytes on "pod"; (d) the port's
   collectives and `pod_compressed_psum` bound to NCCL at one rank (their
   n = 1 path: the result is the input); their cross-rank results are
   held on the CPU only, by 8 gloo ranks (`tests/test_torch_collectives.py`);
19. multi-device placement on the one card, REPRO_HOST_DEVICES=2 logical
   devices sharing it: (a) phase 12's fig11 switch-less 1B uniform cell
   (3 lanes, 300 + 1,200 cycles) with REPRO_SHARD_MIN_WORK=0 on one sweep,
   unsharded then "lanes:2" (two chunks of two lanes, one a ghost): pad
   fraction 0.25, every counter equal lane for lane to phase 12's run,
   one capture for both chunks, the grant launches on the card (2 x
   cycles + the warm-up), cycles/s beside the unsharded run's; (b) the
   fused step channel-sharded, REPRO_CHANNEL_SHARDS=2 ("lanes:1,shards:2",
   the eager loop; `SHARDED_CUT` cycles, printed), equal to the unsharded
   fused run on the same lanes, with its grant form, pad fraction,
   cycles/s beside the captured run's, and peak memory; no arbitration or
   gather kernel runs, and each shard launches the cycle's three draws;
   (c) a two-cell
   spec round-robined (each cell pinned to its logical device) and
   smoke_faults spread over both ("lanes:2") through the runner, and a
   `SimService` with smoke and smoke_faults whose two buckets land on the
   two devices: rows and JSONL equal to the one-device run on the card;
   (d) in an NCCL group of one rank, `launch.train.main` on minicpm-2b at
   full width, 3 steps, trains on `make_host_mesh(model=1)` and equals the
   plain launcher's run at the phase-15 bar; `--production-mesh` on that
   group raises, naming the 256 ranks it needs;
20. the closing slice, timed: (a) `run_scan_batched` on the fused step of
   the smoke_fused scenario's net (2 lanes, 100 + 200 cycles): every
   field of the final state equal to the CPU's, one `cycle_core` launch
   a cycle (+ the capture's warm-up) counted on the card; (b) a
   minicpm-2b smoke trainer's state saved, then restored by
   `Checkpointer.restore(..., shardings=)` with the trainer's specs onto
   a one-rank NCCL mesh: every leaf a DTensor on cuda:0, bit for bit the
   saved one; (c) the example drivers: `examples/torch_quickstart.py`
   with rows equal to the CPU's and its sweep on the grant kernel,
   `examples/torch_serve_lm.py`'s command line and its fp32 greedy
   tokens equal to the CPU's on the same weights, and
   `examples/torch_train_lm.py` for 40 steps with a failure at 25 and a
   snapshot every 20, nll falling.

Then one JSON line of kernel numbers (the netsim entries with the launches
of every path, phases 4, 12-14, 19 and 20, in `by_path`; the flash entry's
launches and timings by served model), the card's name and power limit, and the final
status line.  Exits nonzero, printing no result, without a CUDA
device or without the repository's sources.
"""
from __future__ import annotations

import argparse
import contextlib
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
H100_BF16_OPS_PER_S = 989.4e12  # dense bf16 tensor cores (NVIDIA data sheet)
# 32-bit integer add, logic and shift: 64 a clock on each of the 132 SMs
# at the 1.98 GHz boost clock (Hopper white paper; CUDA's throughput table
# for compute capability 9.0)
H100_INT32_OPS_PER_S = 132 * 64 * 1.98e9
FULL_RATES, FULL_SEEDS = (0.1, 0.4), (0, 1)
FAST_RATES = (0.4, 1.0)
FAST_STEPS = ("fused", "compact")
FULL_CFG = dict(warmup=300, measure=1200)
LIVE_CYCLES = 50
FA_TOL = {"float32": 2e-5, "bfloat16": 2e-2}    # as tests/test_kernels.py
SERVE_BATCH, SERVE_GEN = 4, 16
# (arch, prompt) of each served model; recurrentgemma's prompt is twice its
# 2,048-token window, so the window masks in the prefill and decode wraps
# the ring cache
SERVE = (("llama3.2-3b", 2048), ("mamba2-780m", 2048),
         ("recurrentgemma-2b", 4096))
SSD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}   # as tests/test_kernels.py
SERVE_SAMPLES = 5     # timed generate calls a served model


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


def graph_ms(fn, calls=20, reps=20):
    """Time per call of `calls` back-to-back calls of `fn` captured in one
    CUDA graph (after a warm-up call on the capture stream) and replayed
    `reps` times: what a call costs inside the main path's graphs."""
    import torch
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(calls):
            fn()
    return cuda_ms(graph.replay, reps) / calls


def phase_build():
    """Build every kernel library of the port, one nvcc each, started
    together."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.netsim import ops
    from repro_torch.kernels.rglru import ops as rglru_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    mods = (ops, fa_ops, ssd_ops, rglru_ops)
    t0 = time.perf_counter()
    with ThreadPoolExecutor() as pool:
        list(pool.map(lambda mod: mod.library(), mods))
    print(f"[build] all kernel libraries loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    for mod in mods:
        rec = build.build_record(mod.LIBRARY)
        names = ", ".join(p.name for p in mod.SOURCES)
        print(f"[build] {mod.LIBRARY} ({names}): nvcc "
              f"{rec['seconds']:.2f} s")
        for line in rec["report"].splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                print(f"[build]   {line.strip()}")
    for mod in (fa_ops, ssd_ops):
        hgmma = sass_count(build.build_record(mod.LIBRARY)["path"], "HGMMA")
        check(hgmma > 0, f"no HGMMA instruction in the {mod.LIBRARY} library")
        print(f"[build] {mod.LIBRARY} SASS (cuobjdump -sass): {hgmma} HGMMA "
              f"instructions")
    for fn, ops_ in sass_atomics(build.build_record(ops.LIBRARY)["path"]
                                 ).items():
        print(f"[build] netsim SASS (cuobjdump -sass), {fn}: atomics "
              f"{ops_}")


def sass_count(path, opcode) -> int:
    """Lines of `cuobjdump -sass` of a built library that hold `opcode`."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                         text=True, check=True)
    return sum(opcode in line for line in out.stdout.splitlines())


def sass_atomics(path) -> dict:
    """{kernel function: {atomic or reduction opcode: lines}} of
    `cuobjdump -sass` of a built library."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                         text=True, check=True)
    found, fn = {}, None
    for line in out.stdout.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            fn = head.group(1)
            continue
        op = re.search(r"\b((?:ATOMS|ATOMG|ATOM|RED)\.?[A-Z0-9.]*)", line)
        if op and fn:
            ops_ = found.setdefault(fn, {})
            ops_[op.group(1)] = ops_.get(op.group(1), 0) + 1
    return found


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
    from repro_torch.kernels.netsim import ops
    keys = torch.stack([jr.PRNGKey(s) for s in (0, 1, 2, 3)])
    draws = [lambda k: jr.split(k, 3),
             lambda k: jr.random_bits(k, (5248,)),
             lambda k: jr.uniform(k, (5248,)),
             lambda k: jr.randint(k, (5248,), 0, 5247),
             lambda k: jr.randint(k, (5248,), 0, 41),
             lambda k: jr.bernoulli(k, 0.5, (5248,)),
             # the step's subkeys: strided views of a split
             lambda k: jr.uniform(jr.split(k, 3)[..., 1, :], (5248,))]
    d0 = ops.device_launches()["threefry"]
    for i, f in enumerate(draws):
        for key in (keys, keys[0]):
            a, b = f(key.to(device)).cpu(), f(key)
            check(torch.equal(a, b), f"PRNG draw {i}: CUDA != CPU")
    torch.cuda.synchronize()
    d1 = ops.device_launches()["threefry"]
    got = {k: d1[k] - d0[k] for k in d1}
    want = dict(split=4, bits=2, uniform=4, randint=4, bernoulli=2)
    check(got == want, f"PRNG draws launched {got} != {want}, one a draw")
    print(f"[prng] threefry known answers (torch ops on the card) and "
          f"split/bits/uniform/randint/bernoulli on the threefry kernel, "
          f"one key and 4 lanes, strided subkeys: CUDA == CPU, bit for "
          f"bit; launches on the card {got}")


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
    """Max |kernel - plain| over both outputs (as integers), for both
    kernels."""
    from repro_torch.kernels.netsim import grant, grant_ref, ops
    want = grant_ref(*args, buf_pkts=buf_pkts)
    err = 0
    for kernel in ops.KERNELS:
        got = grant(*args, buf_pkts=buf_pkts, kernel=kernel)
        err = max([err] + [int((g.int() - w.int()).abs().max())
                           for g, w in zip(got, want)])
    return err


def phase_grant_random(device):
    rng = np.random.default_rng(0)
    err = 0
    for B, N, E in [(1, 1, 1), (1, 4099, 291), (4, 204673, 30177),
                    (4, 204672, 30176), (1, 100003, 1029),
                    (1, 20000, 241280)]:
        err = max(err, _grant_err(_random_grant_inputs(rng, B, N, E, device),
                                  8))
    check(err == 0, f"grant kernels != grant_ref on random inputs ({err})")
    print("[grant] random inputs (B in {1,4}, E in {1,291,30176,30177,1029,"
          "241280}): coop and three-pass kernels == grant_ref")
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
        win3, won3 = grant(*args, buf_pkts=cfg.buf_pkts, kernel="three_pass")
        err = max(err, int((win3.int() - rwin.int()).abs().max()),
                  int((won3.int() - rwon.int()).abs().max()))
        granted += int(win.sum())
        state = apply_moves(state, req, win, won, t)
    check(err == 0, f"grant kernel != grant_ref on live states ({err})")
    check(granted > 0, "live states granted nothing")
    print(f"[grant] live full-width states, {cycles} cycles x {B} lanes "
          f"(N = {args[0].shape[1]} rows, E = {args[5].shape[1]} channels, "
          f"{granted} grants): coop and three-pass kernels == grant_ref")
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
    """The coop kernel, the three-pass kernel and the plain version on the
    same inputs (time per call of back-to-back calls)."""
    from repro_torch.kernels.netsim import grant, grant_ref
    B = args[0].shape[0]
    ms = cuda_ms(lambda: grant(*args, buf_pkts=buf_pkts, kernel="coop"), 200)
    replayed_ms = graph_ms(lambda: grant(*args, buf_pkts=buf_pkts,
                                         kernel="coop"))
    three_ms = cuda_ms(lambda: grant(*args, buf_pkts=buf_pkts,
                                     kernel="three_pass"), 200)
    plain_ms = cuda_ms(lambda: grant_ref(*args, buf_pkts=buf_pkts), 50)
    nbytes = grant_bytes(args)
    bound_ms = nbytes / H100_BYTES_PER_S * 1e3
    print(f"[grant] full width B={B}: coop kernel {ms * 1e3:.2f} us/launch "
          f"called eagerly ({replayed_ms * 1e3:.2f} us replayed in a CUDA "
          f"graph), three-pass "
          f"{three_ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, bound "
          f"{bound_ms * 1e3:.2f} us ({nbytes} bytes at 3.35 TB/s)")
    return dict(ms=ms, graph_ms=replayed_ms, three_pass_ms=three_ms,
                plain_ms=plain_ms, bound_ms=bound_ms)


def _cycle_err(got, want):
    """Max |kernel - plain| over (won, wprio, win), as integers."""
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


def _random_cycle_inputs(rng, B, N, E, itime_lo, explicit_prio, device):
    import torch
    out = rng.integers(-1, E, (B, N)).astype(np.int32)
    itime = rng.integers(itime_lo, itime_lo + 6, (B, N)).astype(np.int32)
    ok = rng.random((B, N)) < 0.7
    ch_ok = rng.random((B, E)) < 0.8
    r2 = 1 << (4 * N - 1).bit_length()
    prio = (np.stack([rng.permutation(r2)[:N] for _ in range(B)])
            .astype(np.int32) if explicit_prio else None)
    t = lambda x: None if x is None else torch.as_tensor(x).to(device)
    return [t(x) for x in (out, itime, ok, ch_ok)], t(prio), r2


def phase_cycle_core_random(device):
    """Kernel == plain version on random inputs; where the reference's
    packed int32 key would overflow, also == the two-pass `_grant`."""
    import torch
    from repro_torch.core.engine.fused import _grant
    from repro_torch.kernels.netsim import cycle_core, cycle_core_ref, ops
    rng = np.random.default_rng(1)
    err = 0
    for B, N, E in [(1, 1, 1), (1, 4099, 291), (4, 204673, 30177),
                    (4, 204672, 30176), (4, 51169, 30177),
                    (4, 51168, 30176), (1, 100003, 1029),
                    (1, 20000, 241280)]:
        for explicit_prio in (False, True):
            for itime_lo in (0, 2**31 - 8):
                args, prio, r2 = _random_cycle_inputs(
                    rng, B, N, E, itime_lo, explicit_prio, device)
                want = cycle_core_ref(*args, r2=r2, prio=prio)
                # the coop kernel takes the row-index priority only
                for kernel in ops.KERNELS if prio is None else (
                        "three_pass",):
                    got = cycle_core(*args, r2=r2, prio=prio, kernel=kernel)
                    err = max(err, _cycle_err(got, want))
                if itime_lo:
                    out, itime, ok, ch_ok = args
                    p = (torch.arange(N, dtype=torch.int32, device=device)
                         .expand(B, N) if prio is None else prio)
                    ok = ok & (out >= 0)
                    won, wprio = _grant(ok, out, itime, p, ch_ok, E, r2,
                                        False)
                    err = max(err, _cycle_err(got[:2], (won, wprio)))
    check(err == 0, f"cycle_core kernels != plain versions on random "
                    f"inputs ({err})")
    print("[cycle_core] random inputs (B in {1,4}, E in {1,291,30176,30177,"
          "1029,241280}, prio none/explicit, itime near 2^31): coop (prio "
          "none) and three-pass kernels == cycle_core_ref == two-pass "
          "_grant")
    return err


def fast_cfg(impl):
    from repro_torch.core.simulator import SimConfig
    return SimConfig(**FULL_CFG, step_impl=impl)


def phase_cycle_core_live(net, device, impl, cycles=LIVE_CYCLES):
    """Kernel vs plain version on the live states of the first `cycles`
    cycles of the `impl` step's main-path lanes: every call the step makes
    is checked (`ops.cycle_core` is wrapped for this phase only).  Returns
    (max error, the last call's arguments)."""
    import torch
    from repro_torch import random as jr
    from repro_torch.core import traffic
    from repro_torch.core.engine import build_lane, make_state, make_step
    from repro_torch.core.engine.step import run_scan
    from repro_torch.core.engine.sweep import offered_to_rate_pkt
    from repro_torch.core.routing import share_lanes
    from repro_torch.kernels.netsim import ops
    cfg = fast_cfg(impl)
    lanes = [(r, s) for r in FAST_RATES for s in FULL_SEEDS]
    B = len(lanes)
    tpc = net.num_terminals / net.num_chips
    rates = torch.tensor([offered_to_rate_pkt(r, cfg, tpc) for r, _ in lanes],
                         dtype=torch.float32, device=device)
    keys = torch.stack([jr.PRNGKey(s) for _, s in lanes]).to(device)
    step, consts = make_step(net, cfg, traffic.uniform(net), device=device)
    fl = share_lanes(build_lane(net, cfg, None, device=device), B)
    state = make_state(net, cfg, consts["NV"], batch=(B,), device=device)
    real = ops.cycle_core
    seen = dict(err=0, won=0, calls=0, last=None)

    def checked(*args, **kw):
        got = real(*args, **kw)
        want = ops.cycle_core_ref(*args, **kw)
        # both kernels where the call takes both
        other = real(*args, **kw, kernel="three_pass" if kw.get("prio")
                     is None else None)
        seen["err"] = max(seen["err"], _cycle_err(got, want),
                          _cycle_err(other, want))
        seen["won"] += int(got[0].sum())
        seen["calls"] += 1
        seen["last"] = (args, kw)
        return got

    # the wrapper counts its launches on whatever `ops.cycle_core` names,
    # so this phase's launches land on `checked` and are not counted
    checked.launches = 0
    checked.launches_by_kernel = dict.fromkeys(ops.KERNELS, 0)
    ops.cycle_core = checked
    try:
        run_scan(step, cycles, -1, state, rates, keys, fl)
    finally:
        ops.cycle_core = real
    check(seen["calls"] == cycles, f"{impl}: {seen['calls']} cycle_core "
                                   f"calls in {cycles} cycles")
    check(seen["err"] == 0, f"cycle_core kernel != cycle_core_ref on live "
                            f"{impl} states ({seen['err']})")
    check(seen["won"] > 0, f"live {impl} states granted nothing")
    args, kw = seen["last"]
    kernel = ops.kernel_for(kw.get("prio") is not None)
    print(f"[cycle_core] live full-width {impl} states, {cycles} cycles x "
          f"{B} lanes (N = {args[0].shape[1]} rows, E = {args[3].shape[1]} "
          f"channels, {seen['won']} grants, kernel {kernel}): coop (prio "
          f"none) and three-pass kernels == cycle_core_ref")
    return seen["err"], seen["last"]


def cycle_core_bytes(args, kw) -> int:
    """Bytes `cycle_core` must move: each input read once (out, itime,
    ok, the optional prio, ch_ok), each output written once (won 1 byte
    and wprio 4 bytes a channel, win 1 byte a row)."""
    rows = list(args[:3]) + ([kw["prio"]] if kw.get("prio") is not None
                             else [])
    ch_ok = args[3]
    total = sum(x.numel() * x.element_size() for x in rows)
    total += (ch_ok[0] if ch_ok.stride(0) == 0 else ch_ok).numel()
    return total + ch_ok.numel() * 5 + args[0].numel()


def phase_cycle_core_timing(impl, args, kw):
    """Each kernel that takes the call (the coop kernel: the row-index
    priority only) and the plain version on the same inputs (time per call
    of back-to-back calls); `ms` is the time of the kernel the rule
    picks."""
    from repro_torch.kernels.netsim import cycle_core, cycle_core_ref, ops
    B, N = args[0].shape
    E = args[3].shape[1]
    explicit = kw.get("prio") is not None
    kernel = ops.kernel_for(explicit)
    t = {f"{k}_ms": cuda_ms(lambda: cycle_core(*args, **kw, kernel=k), 200)
         for k in ops.KERNELS if not (explicit and k == "coop")}
    replayed_ms = graph_ms(lambda: cycle_core(*args, **kw, kernel=kernel))
    plain_ms = cuda_ms(lambda: cycle_core_ref(*args, **kw), 50)
    nbytes = cycle_core_bytes(args, kw)
    bound_ms = nbytes / H100_BYTES_PER_S * 1e3
    print(f"[cycle_core] {impl} shapes B={B} N={N} E={E}: "
          + ", ".join(f"{k[:-3]} kernel {v * 1e3:.2f} us/launch"
                      for k, v in t.items())
          + f" called eagerly; the path runs {kernel}: "
            f"{replayed_ms * 1e3:.2f} us/launch replayed in a CUDA graph; "
            f"plain {plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us "
            f"({nbytes} bytes at 3.35 TB/s)")
    return dict(t, ms=t[f"{kernel}_ms"], graph_ms=replayed_ms, kernel=kernel,
                plain_ms=plain_ms, bound_ms=bound_ms)


class ConservationProbe:
    """Wraps every step a sweep runs (its own and, for the compact step,
    each escalation rung's) and records each lane's in-flight packets
    after every cycle of the latest run, so measured counters can be held
    to ``generated == delivered + dropped + reaped + in-flight`` between
    the warmup cycle and the last.  The record is a device write at the
    row of the step's cycle index, with no host synchronisation, so the
    probed step can be captured in a CUDA graph; the first call (the
    capture's warm-up, outside the graph) allocates it."""

    def __init__(self, sweep, warmup, last):
        self.warmup, self.last = warmup, last
        self.rows = None      # [last + 1, lanes] in-flight after cycle t
        sweep.step = self.wrap(sweep.step)
        build = sweep._build_step
        sweep._build_step = lambda *a: self.wrap(build(*a))

    def wrap(self, step):
        import torch

        def probed(state, t_key_rate_fl):
            state, aux = step(state, t_key_rate_fl)
            t = t_key_rate_fl[0]
            inflight = state.b_count.sum((1, 2)) + state.s_count.sum(1)
            if self.rows is None:
                self.rows = torch.zeros((self.last + 1,) + inflight.shape,
                                        dtype=inflight.dtype,
                                        device=inflight.device)
            row = (t.long().view(1) if isinstance(t, torch.Tensor)
                   else torch.tensor([t], device=inflight.device))
            self.rows.index_copy_(0, row, inflight[None])
            return state, aux
        for name in ("compact_capacity", "compact_rows"):
            if hasattr(step, name):
                setattr(probed, name, getattr(step, name))
        return probed

    def check_lanes(self, grid, tag):
        """Exact conservation on every lane of `grid`; prints each lane."""
        rows = self.rows.cpu()
        self.inflight = {t: rows[t] for t in (self.warmup, self.last)}
        grown = self.inflight[self.last] - self.inflight[self.warmup]
        for i, r in enumerate(grid.flat()):
            print(f"[{tag}]   offered {r.offered_per_chip:.2f} seed "
                  f"{grid.seeds[i % len(grid.seeds)]}: throughput "
                  f"{r.throughput_per_chip:.6f} latency {r.avg_latency:.4f} "
                  f"delivered {r.delivered_pkts} generated "
                  f"{r.generated_pkts} dropped {r.dropped_pkts} reaped "
                  f"{r.reaped_pkts} stranded {r.stranded_pkts} occupancy "
                  f"{r.occupancy_peak} in-flight "
                  f"{int(self.inflight[self.last][i])}")
            check(r.generated_pkts == r.delivered_pkts + r.dropped_pkts
                  + r.reaped_pkts + int(grown[i]),
                  f"{tag}: conservation on lane {i}")


def _lm_kernels():
    """name -> the LM kernels' wrappers, each with its `launches` count."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rglru import ops as rglru_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    return {"flash_attention": fa_ops.flash_attention,
            "ssd_scan": ssd_ops.ssd_scan, "rglru": rglru_ops.rglru_scan}


def _reset_launches():
    from repro_torch.kernels.netsim import ops
    for fn in (getattr(ops, w) for w in ops.WRAPPERS):
        fn.launches = 0
        for kernel in fn.launches_by_kernel:
            fn.launches_by_kernel[kernel] = 0
    for fn in _lm_kernels().values():
        fn.launches = 0
    for name in ("flash_attention", "ssd_scan", "rglru"):
        by_kernel = _lm_kernels()[name].launches_by_kernel
        for kernel in by_kernel:
            by_kernel[kernel] = 0


def fresh_peak():
    """Drop the cached CUDA graphs (each holds its static state and memory
    pool) and reset the peak, so the next peak is one sweep's own (phase
    6; the main path keeps its graphs, as a figure run does)."""
    import torch
    from repro_torch.core.engine.sweep import clear_aot_cache
    clear_aot_cache()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def expected_calls(grid, cycles):
    """The arbitration kernels a sweep's step runs on the card: one a
    cycle of every run (escalation re-runs included) and one a cycle of
    the one-superstep warm-up before each CUDA graph capture (a capture
    records, it runs nothing)."""
    captures = grid.compile_count + grid.escalation_compiles
    return cycles * (1 + grid.escalations) + grid.superstep * captures


def counted(run):
    """`run()` between the netsim launch counts: the wrappers' host counts
    set to 0 just before it, the kernels' own device counts read just
    before and just after it.  Returns (its result, wall seconds, the
    device launches {wrapper: {kernel: n}}, the host launches alike)."""
    import torch
    from repro_torch.kernels.netsim import ops
    _reset_launches()
    d0 = ops.device_launches()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    d1 = ops.device_launches()
    device = {w: {k: d1[w][k] - d0[w][k] for k in d1[w]} for w in d1}
    host = {w: dict(getattr(ops, w).launches_by_kernel)
            for w in ops.WRAPPERS}
    return out, wall, device, host


def check_counts(tag, wrapper, kernel, grid, cycles, device, host,
                 gathers=()):
    """Every arbitration of the sweep ran on `kernel` of `wrapper`, and
    every (wrapper, kernel) of `gathers` and of `CYCLE_DRAWS` ran as
    often, as the kernels counted it on the card: each cycle of each run
    plus each capture's warm-up (`expected_calls`); nothing else on any
    wrapper.  The host counts ticked where they launched: at each
    capture's warm-up and recording, never at a replay."""
    from repro_torch.kernels.netsim import ops
    calls = expected_calls(grid, cycles)
    captures = grid.compile_count + grid.escalation_compiles
    ran = {(wrapper, kernel), *gathers, *CYCLE_DRAWS}
    for w in ops.WRAPPERS:
        want = {k: calls if (w, k) in ran else 0
                for k in ops.WRAPPER_KERNELS[w]}
        check(device[w] == want,
              f"{tag}: {w} launches on the card {device[w]} != {want} "
              f"(cycles run + warm-up)")
        rec = {k: 2 * grid.superstep * captures if (w, k) in ran else 0
               for k in ops.WRAPPER_KERNELS[w]}
        check(host[w] == rec,
              f"{tag}: {w} host launches {host[w]} != {rec} (a warm-up and "
              f"a recording of each capture)")
    return calls


def graph_line(grid):
    return (f"CUDA graphs: K {grid.superstep}, captures "
            f"{grid.compile_count} (+{grid.escalation_compiles} on "
            f"abandoned rungs), capture {grid.compile_s:.3f} s, run wall "
            f"{grid.wall_s:.3f} s")


def phase_main_path(net, device):
    """The oracle step at offered 0.1 and 0.4; returns (grant launches,
    the grid)."""
    import torch
    from repro_torch.core import traffic
    from repro_torch.core.simulator import SimConfig, Simulator
    cfg = SimConfig(**FULL_CFG)
    cycles = cfg.warmup + cfg.measure
    t0 = time.perf_counter()
    sim = Simulator(net, cfg, traffic.uniform(net), device=device)
    probe = ConservationProbe(sim._batched, cfg.warmup, cycles - 1)
    setup_s = time.perf_counter() - t0
    # the peak from here to the end of the three steps, each step's graph
    # kept in the cache as a figure run keeps it
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    grid, wall, device, host = counted(
        lambda: sim.sweep_grid(list(FULL_RATES), seeds=FULL_SEEDS))
    lanes = len(FULL_RATES) * len(FULL_SEEDS)
    print(f"[main] radix-16 g=41: {net.num_chips} chips, "
          f"{net.num_channels} channels, {lanes} lanes x {cycles} cycles "
          f"(set-up {setup_s:.2f} s), step jnp")
    probe.check_lanes(grid, "main")
    for r in grid.flat():
        if r.offered_per_chip == 0.1:
            check(abs(r.throughput_per_chip - 0.1) <= 0.005,
                  f"accepted {r.throughput_per_chip} != offered 0.1")
    launches = check_counts("main", "grant", "coop", grid, cycles, device,
                            host)
    print(f"[main] wall {wall:.3f} s: {cycles / wall:.2f} cycles/s, "
          f"{lanes * cycles / wall:.2f} lane-cycles/s; {graph_line(grid)}; "
          f"grant launches on the card {device['grant']}, from the host "
          f"{host['grant']}; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} bytes (before the step "
          f"{base})")
    return dict(launches=launches, launches_by_kernel=device["grant"],
                host_launches_by_kernel=host["grant"],
                threefry=device["threefry"],
                cycles_per_s=cycles / wall,
                run_cycles_per_s=cycles / grid.wall_s,
                memory_before=base), grid


def phase_fast_path(net, device, impl, kernel):
    """One fast step at offered 0.4 and 1.0, every cycle_core launch on
    `kernel`; returns (its launch counts and cycles/s, the grid)."""
    import torch
    from repro_torch.core import traffic
    from repro_torch.core.simulator import Simulator
    cfg = fast_cfg(impl)
    cycles = cfg.warmup + cfg.measure
    t0 = time.perf_counter()
    sim = Simulator(net, cfg, traffic.uniform(net), device=device)
    probe = ConservationProbe(sim._batched, cfg.warmup, cycles - 1)
    setup_s = time.perf_counter() - t0
    grid, wall, device, host = counted(
        lambda: sim.sweep_grid(list(FAST_RATES), seeds=FULL_SEEDS))
    lanes = len(FAST_RATES) * len(FULL_SEEDS)
    runs = 1 + grid.escalations
    print(f"[{impl}] radix-16 g=41: {lanes} lanes x {cycles} cycles "
          f"(set-up {setup_s:.2f} s), step {impl}: grant_form "
          f"{grid.grant_form}, compact_capacity {grid.compact_capacity}, "
          f"occupancy_peak {grid.occupancy_peak}, escalations "
          f"{grid.escalations}")
    probe.check_lanes(grid, impl)
    # the fused step's record gathers launch as often as its arbitration
    launches = check_counts(impl, "cycle_core", kernel, grid, cycles,
                            device, host, STEP_GATHERS.get(impl, ()))
    print(f"[{impl}] wall {wall:.3f} s ({runs} run(s)): "
          f"{cycles * runs / wall:.2f} cycles/s, "
          f"{lanes * cycles * runs / wall:.2f} lane-cycles/s; "
          f"{graph_line(grid)}; cycle_core launches on the card "
          f"{device['cycle_core']}, from the host {host['cycle_core']}; "
          f"head_records launches on the card {device['head_records']}; "
          f"threefry launches on the card {device['threefry']}; "
          f"max_memory_allocated since the main path began "
          f"{torch.cuda.max_memory_allocated()} bytes")
    return dict(launches=launches, launches_by_kernel=device["cycle_core"],
                host_launches_by_kernel=host["cycle_core"],
                head_records=device["head_records"],
                threefry=device["threefry"],
                cycles_per_s=cycles * runs / wall,
                run_cycles_per_s=cycles * runs / grid.wall_s), grid


def main_path_memory(before):
    """What the process holds after the three main-path steps ran, each
    step's graph left in the cache: memory allocated and reserved now, and
    the peak since the main path began."""
    import torch
    from repro_torch.core.engine import graphs
    held = dict(graphs_cached=len(graphs._GRAPHS), before=before,
                memory_allocated=torch.cuda.memory_allocated(),
                max_memory_allocated=torch.cuda.max_memory_allocated(),
                memory_reserved=torch.cuda.memory_reserved())
    print(f"[main] the three steps in one process, {held['graphs_cached']} "
          f"graphs cached: memory_allocated {held['memory_allocated']}, "
          f"max_memory_allocated {held['max_memory_allocated']}, "
          f"memory_reserved {held['memory_reserved']} bytes (allocated "
          f"before the main path {before})")
    return held


def check_fast_grids(oracle, grids):
    """fused == compact on every lane; their 0.4 lanes == the oracle's."""
    rows = {k: [dataclasses.asdict(r) for r in g.flat()]
            for k, g in grids.items()}
    check(rows["fused"] == rows["compact"],
          "fused != compact at full width")
    S = len(FULL_SEEDS)
    i_fast, i_oracle = FAST_RATES.index(0.4), FULL_RATES.index(0.4)
    for j in range(S):
        check(dataclasses.asdict(grids["fused"].result(i_fast, j))
              == dataclasses.asdict(oracle.result(i_oracle, j)),
              f"fused != oracle at offered 0.4, seed {FULL_SEEDS[j]}")
    print(f"[main] fused == compact on all {len(rows['fused'])} lanes; "
          f"their 0.4 lanes == the oracle's, field for field")


def phase_profile(net, device, impl, per_call, cycles=20):
    """torch.profiler over a short steady window of one main-path step
    (offered 0.4 on every lane), whose grant / cycle_core call must be
    `per_call` kernels (1 for the coop kernel, 3 for the three-pass)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import random as jr
    from repro_torch.core import traffic
    from repro_torch.core.engine import build_lane, make_state, make_step
    from repro_torch.core.engine.step import run_scan
    from repro_torch.core.routing import share_lanes
    cfg = fast_cfg(impl)
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
    n = profile_report(prof, wall, f"{impl}, {cycles} cycles", cycles,
                       "cycle", ("grant", "cycle_"))
    print(f"[profile]   grant / cycle_core kernels per call: "
          f"{n / cycles:.2f}")
    check(n == cycles * per_call, f"{impl}: {n} grant / cycle_core kernels "
                                  f"in {cycles} calls, not {per_call} a "
                                  f"call")


# the benchmark's radix-16 switch-less network at 24 lanes: lanes B,
# channels E, requesting channels E_req, VCs NV, buffer slots S
HEAD_SHAPE = (24, 30_176, 24_928, 8, 8)


def head_records_bytes(B, rows, E) -> tuple[int, int]:
    """Bytes the two gathers must move (dense, picked): each 32-byte
    record read and written once, with its int32 head slot (dense: B x
    rows heads) or pick (picked: B x E channels)."""
    return B * rows * (32 + 32 + 4), B * E * (4 + 32 + 32)


def phase_head_records_timing(device):
    """The fused step's record gathers alone at `HEAD_SHAPE`: both forms
    bit for bit against the `take` / `lane_take` expressions they replace
    (run on the card), then each timed (back-to-back calls, CUDA events)
    beside that expression and against its byte bound; `ms`, `plain_ms`
    and `bound_ms` are the dense form's, the step's larger gather."""
    import torch
    from repro_torch.core.engine.state import with_sink_row
    from repro_torch.kernels.netsim import (head_records_dense,
                                           head_records_dense_ref,
                                           head_records_picked,
                                           head_records_picked_ref)
    B, E, ER, NV, S = HEAD_SHAPE
    rows = ER * NV
    g = torch.Generator(device=device).manual_seed(0)
    i32 = torch.iinfo(torch.int32)
    store = with_sink_row(torch.randint(
        i32.min, i32.max, (B, E + 1, NV, S, 8), dtype=torch.int32,
        device=device, generator=g).narrow(1, 0, E))
    b_head = torch.randint(0, S, (B, E, NV), dtype=torch.int32,
                           device=device, generator=g)
    idx = torch.randint(0, rows, (B, E), dtype=torch.int32, device=device,
                        generator=g)
    head = head_records_dense(store, b_head, ER)
    check(torch.equal(head, head_records_dense_ref(store, b_head, ER))
          and torch.equal(head_records_picked(head, idx),
                          head_records_picked_ref(head, idx)),
          "head_records != the take expressions it replaces")
    t = dict(
        dense_ms=cuda_ms(lambda: head_records_dense(store, b_head, ER), 50),
        dense_take_ms=cuda_ms(
            lambda: head_records_dense_ref(store, b_head, ER), 20),
        picked_ms=cuda_ms(lambda: head_records_picked(head, idx), 200),
        picked_take_ms=cuda_ms(lambda: head_records_picked_ref(head, idx),
                               50))
    dense_b, picked_b = head_records_bytes(B, rows, E)
    t.update(dense_bound_ms=dense_b / H100_BYTES_PER_S * 1e3,
             picked_bound_ms=picked_b / H100_BYTES_PER_S * 1e3)
    print(f"[head_records] shapes B={B} E={E} E_req={ER} NV={NV} S={S}: "
          f"dense kernel {t['dense_ms'] * 1e3:.2f} us/launch, take "
          f"{t['dense_take_ms'] * 1e3:.2f} us, bound "
          f"{t['dense_bound_ms'] * 1e3:.2f} us ({dense_b} bytes at 3.35 "
          f"TB/s, {100 * t['dense_bound_ms'] / t['dense_ms']:.1f} % of it); "
          f"picked kernel {t['picked_ms'] * 1e3:.2f} us/launch, lane_take "
          f"{t['picked_take_ms'] * 1e3:.2f} us, bound "
          f"{t['picked_bound_ms'] * 1e3:.2f} us ({picked_b} bytes, "
          f"{100 * t['picked_bound_ms'] / t['picked_ms']:.1f} %); both == "
          f"the take expressions")
    return dict(t, ms=t["dense_ms"], plain_ms=t["dense_take_ms"],
                bound_ms=t["dense_bound_ms"])


# the benchmark's radix-16 switch-less cell: 24 lanes of 5,248 terminals
THREEFRY_SHAPE = (24, 5_248)
# int32 operations of one Threefry-2x32 hash as `threefry.cu` runs it:
# the third key word (2), the first injection (2), 20 rounds of add,
# rotate and xor (60), five injections of three adds (15)
THREEFRY_HASH_OPS = 79


def threefry_work(form, lanes, n) -> tuple[int, int]:
    """(bytes, int32 operations) one draw of `form` must take: the lanes'
    keys read and the output written once; a hash an element (a split
    element's two words are one hash), plus the form's own operations
    (bits: the xor; uniform: and the shift, or and subtraction; bernoulli:
    and the compare; randint: two hashes and two xors an element, the
    two subkeys' hashes once a lane, three remainders, a product and two
    sums)."""
    out = {"split": 16, "bits": 8, "uniform": 4, "randint": 4,
           "bernoulli": 1}[form]
    per = {"split": THREEFRY_HASH_OPS, "bits": THREEFRY_HASH_OPS + 1,
           "uniform": THREEFRY_HASH_OPS + 4,
           "bernoulli": THREEFRY_HASH_OPS + 5,
           "randint": 2 * (THREEFRY_HASH_OPS + 1) + 6}[form]
    lane_ops = 2 * THREEFRY_HASH_OPS if form == "randint" else 0
    return lanes * (16 + n * out), lanes * (n * per + lane_ops)


def phase_threefry_timing(device):
    """The PRNG's draws alone at `THREEFRY_SHAPE`, from the strided
    subkeys the step draws from: each form bit for bit against its plain
    version on the card, then timed: a launch eager (back-to-back calls,
    CUDA events) and inside a CUDA graph (as the main path runs it),
    beside the plain version in a graph and against its bound (the
    larger of bytes at 3.35 TB/s and int32 operations at the card's
    rate).  `ms`, `plain_ms` and `bound_ms` are the randint form's, the
    draw with the most work a cycle."""
    import torch
    from repro_torch import random as jr
    from repro_torch.kernels.netsim import ref
    B, T = THREEFRY_SHAPE
    ks = jr.split(jr.split(jr.PRNGKey(2**31 + 11).to(device), B), 3)
    key = ks[:, 0]
    forms = {
        "split": (lambda: jr.split(key, 3),
                  lambda: ref.threefry_split_ref(key, 3), 3),
        "bits": (lambda: jr.random_bits(key, (T,)),
                 lambda: ref.threefry_bits_ref(key, (T,)), T),
        "uniform": (lambda: jr.uniform(key, (T,)),
                    lambda: ref.threefry_uniform_ref(key, (T,)), T),
        "randint": (lambda: jr.randint(key, (T,), 0, T - 1),
                    lambda: ref.threefry_randint_ref(key, (T,), 0, T - 1),
                    T),
        "bernoulli": (lambda: jr.bernoulli(key, 0.5, (T,)),
                      lambda: ref.threefry_bernoulli_ref(key, 0.5, (T,)),
                      T)}
    out = {}
    for form, (kernel, plain, n) in forms.items():
        check(torch.equal(kernel(), plain()),
              f"threefry {form} kernel != its plain version")
        nbytes, ops_ = threefry_work(form, B, n)
        by_bytes = nbytes / H100_BYTES_PER_S * 1e3
        by_ops = ops_ / H100_INT32_OPS_PER_S * 1e3
        out[form] = dict(ms=cuda_ms(kernel, 200), graph_ms=graph_ms(kernel),
                         plain_graph_ms=graph_ms(plain, calls=4, reps=10),
                         bound_ms=max(by_bytes, by_ops),
                         bound_by="bytes" if by_bytes >= by_ops
                         else "operations", bytes=nbytes, ops=ops_)
    print(f"[threefry] shape {B} lanes x {T} elements (split: 3), keys the "
          f"strided subkeys of a split; us a launch, eager / in a CUDA "
          f"graph; the plain version in a graph; bound (bytes at 3.35 "
          f"TB/s, int32 operations at {H100_INT32_OPS_PER_S / 1e12:.2f} "
          f"T/s); all == the plain version: " + "; ".join(
              f"{form} {t['ms'] * 1e3:.2f} / {t['graph_ms'] * 1e3:.2f}, "
              f"plain {t['plain_graph_ms'] * 1e3:.2f}, bound "
              f"{t['bound_ms'] * 1e3:.4f} ({t['bound_by']}: {t['bytes']} B, "
              f"{t['ops']} ops; {100 * t['bound_ms'] / t['graph_ms']:.1f} %)"
              for form, t in out.items()))
    head = out["randint"]
    return dict(ms=head["ms"], plain_ms=head["plain_graph_ms"],
                bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                forms=out)


def phase_profile_graph(net, device, impl, K, cycles=40):
    """torch.profiler over `cycles` cycles of one main-path step replayed
    as captured CUDA graphs of K cycles (offered 0.4 on every lane, from
    a state warmed by 100 eager cycles)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import random as jr
    from repro_torch.core import traffic
    from repro_torch.core.engine import (build_lane, graphs, make_state,
                                         make_step)
    from repro_torch.core.engine.step import _key_chain, run_scan
    from repro_torch.core.routing import share_lanes
    cfg = fast_cfg(impl)
    step, consts = make_step(net, cfg, traffic.uniform(net), device=device)
    B = len(FULL_RATES) * len(FULL_SEEDS)
    fl = share_lanes(build_lane(net, cfg, None, device=device), B)
    state = make_state(net, cfg, consts["NV"], batch=(B,), device=device)
    keys = torch.stack([jr.PRNGKey(s) for s in range(B)]).to(device)
    rates = torch.full((B,), 0.025, dtype=torch.float32, device=device)
    state = run_scan(step, 100, -1, state, rates, keys, fl)
    graph, _ = graphs.graph_for(step, K, state, rates, fl)
    subs = _key_chain(keys, cycles)
    graph.run(state, rates, fl, -1, subs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        graph.run(state, rates, fl, -1, subs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    profile_report(prof, wall, f"{impl} CUDA graph K = {K}, {cycles} "
                   f"cycles", cycles, "cycle", ("grant", "cycle_"))
    graphs.clear()


def profile_report(prof, wall, label, n, unit, names):
    """Device busy share and kernels per `unit` of a profiler window, the
    device time per launch of the kernels whose name holds one of `names`,
    and the top of the table; returns those kernels' launches."""
    import torch
    events = prof.key_averages()
    attr = ("self_device_time_total"
            if hasattr(events[0], "self_device_time_total")
            else "self_cuda_time_total")
    kernels = [e for e in events if getattr(e, attr) > 0
               and e.device_type == torch.autograd.DeviceType.CUDA]
    dev = sum(getattr(e, attr) for e in kernels) / 1e3            # ms
    print(f"[profile] {label}: wall {wall * 1e3:.1f} ms, "
          f"device busy {dev:.1f} ms ({100 * dev / (wall * 1e3):.1f}%), "
          f"{sum(e.count for e in kernels) / n:.0f} kernels per {unit}")
    named = 0
    for e in kernels:
        if any(name in e.key for name in names):
            named += e.count
            print(f"[profile]   {e.key}: {getattr(e, attr) / e.count:.2f} us "
                  f"device time per launch, {e.count} launches")
    print(events.table(sort_by=attr, row_limit=12))
    return named


def phase_serve_profile(model, cfg, batch, device, steps=4):
    """torch.profiler over one full-width prefill of `batch` on the
    kernel, then over `steps` decode steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import cache_len, decode_extra
    from repro_torch.models import transformer as TF
    B, S = batch["tokens"].shape
    with torch.inference_mode():
        cache = TF.init_cache(cfg, B, cache_len(cfg, S, steps), device=device)
        inputs = batch
        for mode, n in (("prefill", 1), ("decode", steps)):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(n):
                    logits, cache, _ = TF.forward(
                        model, cfg, inputs, mode, cache=cache,
                        attn_impl="kernel" if mode == "prefill" else "naive")
                    tok = torch.argmax(logits[:, -1:], dim=-1).int()
                    inputs = {"tokens": tok, **decode_extra(cfg, batch)}
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            del logits
            profile_report(prof, wall, f"{cfg.name} {mode}, {n} step(s)",
                           n, "step", ("flash_fwd", "ssd_scan", "rglru"))


SMALL = dict(a=2, b=2, m=2, n=4, noc=2, g=3)


def phase_small_parity(device):
    """The port on `device` against the port on the CPU, field for field,
    for every cycle step; then a compact run pinned below its live peak
    escalates identically on both."""
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
    for impl in ("jnp",) + FAST_STEPS:
        for name, over, run in cases:
            cfg = SimConfig(**cyc, **over, step_impl=impl)
            got = [run(Simulator(net, cfg, traffic.uniform(net), device=d))
                   for d in (device, "cpu")]
            a, b = ([dataclasses.asdict(r) for r in g.flat()] for g in got)
            check(a == b, f"small-net parity {impl} {name}: CUDA != CPU")
            print(f"[parity] {impl} {name}: {len(a)} lanes, CUDA == CPU "
                  f"(delivered {[r['delivered_pkts'] for r in a]})")
    cfg = SimConfig(**cyc, step_impl="compact")
    lanes = [(r, s, None) for r in (0.3, 1.2) for s in (0, 1)]
    runs = [Simulator(net, cfg, traffic.uniform(net), device=d)._batched
            .run_lanes_async(lanes, capacity=40).finish()
            for d in (device, "cpu")]
    a, b = ([dataclasses.asdict(r) for r in run.results] for run in runs)
    check(runs[0].escalations >= 1, "pinned compact run did not escalate")
    check(a == b and runs[0].escalations == runs[1].escalations
          and runs[0].compact_capacity == runs[1].compact_capacity,
          "small-net parity compact pinned to capacity 40: CUDA != CPU")
    print(f"[parity] compact pinned to capacity 40: {runs[0].escalations} "
          f"escalation(s) to rung {runs[0].compact_capacity} (occupancy "
          f"peak {runs[0].occupancy_peak}), CUDA == CPU")


# phase 6's small-network runs: a K = 4 superstep holds the warm onset
# (cycle 61) and the warmup reset (62); the paper network's comparison
# runs 300 cycles
GRAPH_SMALL = dict(warmup=62, measure=118)
GRAPH_PAPER = dict(warmup=100, measure=200)
GRAPH_K = (1, 4)


class superstep_env:
    """REPRO_SUPERSTEP set to `k` inside the block, restored after it."""

    def __init__(self, k):
        self.k = k

    def __enter__(self):
        import os
        self.old = os.environ.get("REPRO_SUPERSTEP")
        os.environ["REPRO_SUPERSTEP"] = str(self.k)

    def __exit__(self, *exc):
        import os
        if self.old is None:
            os.environ.pop("REPRO_SUPERSTEP", None)
        else:
            os.environ["REPRO_SUPERSTEP"] = self.old


def _grid_rows(grid):
    return [dataclasses.asdict(r) for r in grid.flat()]


def phase_graphs(net, device):
    """The captured CUDA graphs against the eager loop, bit for bit: on
    the small network with a warm onset and the warmup reset inside a
    K = 4 superstep, then on the paper network (4 lanes) at K = 1 and 4,
    each step timed both ways; the lane forms timed at the paper's scale;
    the deadlock proof on the card against the CPU.  Returns the paper
    network's numbers per step."""
    import torch
    from repro_torch.core import topology as T
    from repro_torch.core import traffic
    from repro_torch.core.engine import make_state
    from repro_torch.core.engine import sweep as SW
    from repro_torch.core.simulator import SimConfig, Simulator
    small = T.build_switchless(T.SwitchlessParams(**SMALL), "small")
    glob = np.where(small.ch_type == T.GLOBAL)[0]
    cold = T.FaultSet(dead_ch=tuple(int(c) for c in glob[:2]))
    rows = [T.FaultSet(), cold,
            T.FaultSchedule(((0, T.FaultSet()), (61, cold)))]
    for impl in ("jnp",) + FAST_STEPS:
        cfg = SimConfig(**GRAPH_SMALL, vc_mode="updown", reap_age=20,
                        step_impl=impl)
        eager = Simulator(small, cfg, traffic.uniform(small), device=device,
                          loop="eager").sweep_faults(1.2, rows, (0, 1))
        with superstep_env(4):
            got = Simulator(small, cfg, traffic.uniform(small),
                            device=device).sweep_faults(1.2, rows, (0, 1))
        check(got.superstep == 4 and got.compile_count >= 1,
              f"small-net {impl}: K {got.superstep}, captures "
              f"{got.compile_count}")
        check(_grid_rows(got) == _grid_rows(eager),
              f"small-net {impl}: captured K = 4 != eager")
        print(f"[graphs] small net {impl}: captured K = 4 == eager on "
              f"{len(rows) * 2} lanes (pristine, cold, warm onset 61, "
              f"reset at 62, reaper on)")
    out = {}
    for impl, rates in (("jnp", FULL_RATES),) + tuple(
            (i, FAST_RATES) for i in FAST_STEPS):
        cfg = SimConfig(**GRAPH_PAPER, step_impl=impl)
        cycles = cfg.warmup + cfg.measure
        sim = Simulator(net, cfg, traffic.uniform(net), device=device,
                        loop="eager")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager = sim.sweep_grid(list(rates), seeds=FULL_SEEDS)
        torch.cuda.synchronize()
        runs = 1 + eager.escalations
        res = dict(eager_cycles_per_s=cycles * runs
                   / (time.perf_counter() - t0))
        for K in GRAPH_K:
            with superstep_env(K):
                sim = Simulator(net, cfg, traffic.uniform(net),
                                device=device)
                fresh_peak()
                first = sim.sweep_grid(list(rates), seeds=FULL_SEEDS)
                peak = torch.cuda.max_memory_allocated()
                before = SW.compile_counter()
                again = sim.sweep_grid(list(rates), seeds=FULL_SEEDS)
            check(SW.compile_counter() == before and again.compile_count == 0,
                  f"{impl} K {K}: the second sweep captured")
            for g in (first, again):
                check(g.superstep == K and _grid_rows(g) == _grid_rows(eager),
                      f"paper net {impl} K {K}: captured != eager")
            res[f"K{K}"] = dict(
                cycles_per_s=cycles * (1 + again.escalations) / again.wall_s,
                capture_s=first.compile_s,
                captures=first.compile_count + first.escalation_compiles,
                max_memory_allocated=peak)
        out[impl] = res
        print(f"[graphs] paper net {impl}: {len(rates) * len(FULL_SEEDS)} "
              f"lanes x {cycles} cycles, captured == eager at K = "
              f"{GRAPH_K}; cycles/s eager {res['eager_cycles_per_s']:.2f}, "
              + ", ".join(
                  f"graph K = {K} {res[f'K{K}']['cycles_per_s']:.2f} "
                  f"(capture {res[f'K{K}']['capture_s']:.3f} s, "
                  f"{res[f'K{K}']['captures']} capture(s), "
                  f"max_memory_allocated "
                  f"{res[f'K{K}']['max_memory_allocated']} bytes)"
                  for K in GRAPH_K))
    for impl, rates in (("jnp", FULL_RATES),) + tuple(
            (i, FAST_RATES) for i in FAST_STEPS):
        cfg = SimConfig(**GRAPH_PAPER, step_impl=impl)
        cycles = cfg.warmup + cfg.measure
        sw = Simulator(net, cfg, traffic.uniform(net), device=device)._batched
        _, rt, keys, fl, _ = sw._prepare_lanes(
            [(r, s, None) for r in rates for s in FULL_SEEDS])
        keys = keys.to(device)
        lane_cps, stats = {}, {}
        for form, scan in (("lockstep", SW._scan_lanes),
                           ("sequential", SW._scan_lanes_seq)):
            args = lambda: (make_state(net, cfg, sw.NV, batch=(len(rt),),
                                       device=device), rt, keys, fl)
            scan(sw.step, cycles, cfg.warmup, 1, "graph", *args())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stats[form] = scan(sw.step, cycles, cfg.warmup, 1, "graph",
                               *args())[0]
            torch.cuda.synchronize()
            lane_cps[form] = len(rt) * cycles / (time.perf_counter() - t0)
        check(all(torch.equal(v, getattr(stats["sequential"], k))
                  for k, v in vars(stats["lockstep"]).items()),
              f"{impl}: sequential lanes != lockstep")
        pick = SW.lane_form(sw.step, device)
        out[impl]["lane_cycles_per_s"] = lane_cps
        out[impl]["lane_form"] = pick
        print(f"[graphs] lane form {impl}: lockstep "
              f"{lane_cps['lockstep']:.2f} lane-cycles/s, sequential "
              f"{lane_cps['sequential']:.2f} (equal counters); the planner "
              f"picks {pick}; faster in this run: "
              f"{max(lane_cps, key=lane_cps.get)}")
    SW.clear_aot_cache()
    torch.cuda.empty_cache()
    from repro_torch.core.routing import assert_deadlock_free
    net7 = T.build_switchless(T.paper_radix16_switchless(g=7))
    for mode in ("baseline", "updown", "updown_merged"):
        edges = [assert_deadlock_free(net7, mode, True,
                                      np.random.default_rng(3),
                                      n_pairs=5000, device=d)
                 for d in (device, "cpu")]
        check(edges[0] == edges[1], f"deadlock proof {mode}: card {edges[0]}"
                                    f" != CPU {edges[1]} CDG edges")
        print(f"[graphs] assert_deadlock_free radix-16 g=7 {mode} "
              f"non-minimal: card == CPU, {edges[0]} CDG edges, acyclic")
    return out


# the flash kernel's shapes on the served prefills (B, Sq, Sk, H, KV, hd)
FA_LLAMA = (SERVE_BATCH, 2048, 2048, 24, 8, 128)
FA_GEMMA = (SERVE_BATCH, 4096, 4096, 10, 1, 256)
FA_GEMMA_WINDOW = 2048
# deepseek-moe-16b's prefill (phase 16): 16 heads of 128, MHA
FA_DEEPSEEK = (SERVE_BATCH, 2048, 2048, 16, 16, 128)
# phase 17: phi-3-vision-4.2b's prefill, 576 prefix rows + 2,048 tokens,
# 32 MHA heads of 96 (zero-padded to 128 by the wrapper); seamless-m4t-
# medium's encoder (non-causal) and decoder (causal), 16 MHA heads of 64
FA_PHI = (SERVE_BATCH, 576 + 2048, 576 + 2048, 32, 32, 96)
FA_SEAMLESS = (SERVE_BATCH, 2048, 2048, 16, 16, 64)
# label -> (shape, causal) of the served prefills' bf16 flash shapes that
# phase 7 times
FA_TIMED = {"serving prefill": (FA_LLAMA, True),
            "recurrentgemma prefill": (FA_GEMMA, True),
            "deepseek prefill": (FA_DEEPSEEK, True),
            "phi-3-vision prefill": (FA_PHI, True),
            "seamless encoder": (FA_SEAMLESS, False),
            "seamless decoder": (FA_SEAMLESS, True)}


def _fa_cases():
    """(label, shape (B, Sq, Sk, H, KV, hd), dtype, kwargs) of phase 7."""
    shapes = [(1, 128, 128, 2, 2, 64), (2, 256, 256, 4, 2, 64),
              (2, 192, 320, 4, 1, 80), (1, 512, 512, 8, 8, 128),
              (1, 64, 64, 10, 1, 256)]
    cases = [("sweep", s, dt, dict(causal=True))
             for s in shapes for dt in ("float32", "bfloat16")]
    cases += [(f"window {w}", (2, 256, 256, 4, 2, 64), "float32",
               dict(causal=True, window=w)) for w in (32, 128)]
    cases += [("non-causal Sk=96", (1, 128, 96, 2, 2, 64), "float32",
               dict(causal=False)),
              ("non-causal ragged Sk=200", (1, 128, 200, 2, 2, 64),
               "float32", dict(causal=False))]
    # the tensor-core kernel's edges, bf16: Sq and Sk off its tiles, GQA
    # with 3 groups and MQA, windows off the tile and at the served
    # 2,048 over 4,096 keys, non-causal with Sq != Sk
    cases += [(label, shape, "bfloat16", kw) for label, shape, kw in (
        ("tile edges", (2, 200, 333, 6, 2, 128), dict(causal=True)),
        ("tile edges MQA", (2, 200, 333, 4, 1, 64), dict(causal=True)),
        ("GQA 3 groups", (2, 256, 256, 6, 2, 128), dict(causal=True)),
        ("MQA", (1, 192, 192, 4, 1, 256), dict(causal=True)),
        ("window 100", (1, 333, 333, 4, 1, 256),
         dict(causal=True, window=100)),
        ("window 100", (1, 300, 300, 6, 2, 128),
         dict(causal=True, window=100)),
        ("window 2048", (1, 4096, 4096, 2, 1, 256),
         dict(causal=True, window=2048)),
        ("non-causal Sq < Sk", (2, 200, 333, 6, 2, 128), dict(causal=False)),
        ("non-causal Sq > Sk", (2, 333, 200, 4, 1, 256), dict(causal=False)),
        ("non-causal Sq > Sk", (1, 333, 200, 2, 2, 64), dict(causal=False)))]
    # a head dim no kernel is built for (phi-3-vision's), zero-padded
    cases += [("padded hd 96", (2, 200, 200, 4, 2, 96), dt,
               dict(causal=True)) for dt in ("float32", "bfloat16")]
    cases += [("serving prefill", FA_LLAMA, dt, dict(causal=True))
              for dt in ("float32", "bfloat16")]
    cases += [("recurrentgemma prefill", FA_GEMMA, "bfloat16",
               dict(causal=True, window=FA_GEMMA_WINDOW))]
    cases += [(label, shape, "bfloat16", dict(causal=causal))
              for label, (shape, causal) in FA_TIMED.items()
              if label not in ("serving prefill", "recurrentgemma prefill")]
    return cases


def _fa_inputs(seed, shape, dtype, device):
    import torch
    B, Sq, Sk, H, KV, hd = shape
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(s, generator=g, device=device).to(getattr(torch,
                                                                  dtype))
            for s in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd))]


def _row_rel(got, want):
    """(max abs error, max over rows of the row's largest |got - want|
    over its largest |want|), rows along the last axis."""
    row_err = (got.float() - want.float()).abs().amax(-1)
    rel = row_err / want.float().abs().amax(-1).clamp_min(1e-6)
    return float(row_err.max()), float(rel.max())


def phase_flash_attention(device):
    """The kernel against `attention_ref` on the card for every case;
    returns (max abs error, {label: bf16 inputs} of the served prefills'
    shapes, `FA_TIMED`).  The error is relative per output row (one query
    position of one head): each row's largest |kernel - plain| over that
    row's largest |plain|, so a late causal row, an average of thousands
    of values and far smaller than the first row's, is held to its own
    size."""
    import torch
    from repro_torch.kernels.flash_attention import attention_ref, ops
    worst, timed = 0.0, {}
    for i, (label, shape, dtype, kw) in enumerate(_fa_cases()):
        q, k, v = _fa_inputs(i, shape, dtype, device)
        before = dict(ops.flash_attention.launches_by_kernel)
        got = ops.flash_attention(q, k, v, **kw)
        want = attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        ran = [name for name, n in ops.flash_attention.launches_by_kernel
               .items() if n != before[name]]
        kernel = ops.kernel_for(q.dtype, shape[-1])
        check(ran == [kernel], f"flash_attention {label}: ran {ran}, the "
                               f"rule names {kernel}")
        check(bool(torch.isfinite(got).all()), f"flash_attention {label}: "
                                               f"non-finite output")
        diff, rel = _row_rel(got, want)
        del got, want
        check(rel < FA_TOL[dtype], f"flash_attention {label} {dtype}: "
                                   f"relative error {rel} >= {FA_TOL[dtype]}")
        worst = max(worst, diff)
        print(f"[flash] {label} {shape} {dtype} {kw}: {kernel} kernel == "
              f"attention_ref (max abs {diff:.3e}, relative per row "
              f"{rel:.3e})")
        if label in FA_TIMED and dtype == "bfloat16":
            timed[label] = (q, k, v, kw)
        del q, k, v
    return worst, timed


def _causal_pairs(S, window=None, causal=True):
    """(query, key) pairs a causal (windowed) attention over S keys uses;
    every pair without `causal`."""
    if not causal:
        return S * S
    if window is None or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def phase_flash_timing(q, k, v, kw):
    """Kernel, plain version and the SDPA call at a served prefill's shape,
    back to back (with a window, SDPA takes it as a boolean mask; a head
    dim the kernels are not built for, phi-3-vision's 96, goes to SDPA
    unpadded, and the FMA kernel is not timed there); the bound is the
    larger of the bf16 operations at the true head dim at the tensor
    cores' peak and the bytes at the memory's."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import attention_ref, ops
    B, S, H, hd = q.shape
    window, causal = kw.get("window"), kw.get("causal", True)
    ms = cuda_ms(lambda: ops.flash_attention(q, k, v, **kw), 10)
    fma_ms = (cuda_ms(lambda: fma_kernel(q, k, v, **kw), 3)
              if hd in ops.HEAD_DIMS else None)
    plain_ms = cuda_ms(lambda: attention_ref(q, k, v, **kw), 3)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if window is None:
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), 10)
    else:
        pos = torch.arange(S, device=q.device)
        mask = (pos[None, :] <= pos[:, None]) \
            & (pos[None, :] > pos[:, None] - window)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True), 10)
    ops_count = 4 * hd * B * H * _causal_pairs(S, window, causal)
    nbytes = sum(x.numel() * x.element_size() for x in (q, k, v, q))
    ops_ms = ops_count / H100_BF16_OPS_PER_S * 1e3
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    fma = "not built for this hd" if fma_ms is None else f"{fma_ms:.4f} ms"
    print(f"[flash] B={B} S={S} H={H} KV={k.shape[2]} hd={hd} causal "
          f"{causal} window {window} bf16: {ops.kernel_for(q.dtype, hd)} "
          f"kernel {ms:.4f} ms/launch ({ops_count / ms * 1e-9:.1f} TFLOP/s, "
          f"{bound_ms / ms:.3f} of the bound), the FMA kernel on the same "
          f"bf16 inputs {fma}, plain {plain_ms:.4f} ms, SDPA "
          f"{library_ms:.4f} ms, bound {bound_ms * 1e3:.2f} us "
          f"({ops_count} operations: {ops_ms * 1e3:.2f} us at 989.4 TFLOP/s; "
          f"{nbytes} bytes: {bytes_ms * 1e3:.2f} us at 3.35 TB/s)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                library_ms=library_ms, fma_ms=fma_ms)


def fma_kernel(q, k, v, causal=True, window=None):
    """The FMA kernel (csrc/flash_attention.cu) launched on bf16 inputs
    that the dispatch rule sends to the tensor-core kernel: the yardstick
    of the earlier design, timed beside it and used nowhere else."""
    import math
    import torch
    from repro_torch.kernels.flash_attention import ops
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    rc = ops.library().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 1, B, Sq,
        Sk, H, KV, hd, 1.0 / math.sqrt(hd), int(causal),
        int(window is not None), window or 0,
        torch.cuda.current_stream().cuda_stream)
    check(rc == 0, f"FMA flash kernel launch failed: CUDA error {rc}")
    return o


# the SSD scan's shape (B, S, H, P, N) on the mamba2-780m prefill
SSD_SERVING = (SERVE_BATCH, 2048, 48, 64, 128)


def _ssd_cases():
    """(label, (B, S, H, P, N), dtype, as views) of phase 8: the property
    sweep's space and the chunk-invariance shape of tests/test_kernels.py,
    the tensor-core kernel's edges in bf16, then the mamba2-780m
    prefill's."""
    shapes = [(1, 64, 2, 16, 16), (2, 100, 2, 64, 32), (3, 192, 2, 16, 32),
              (1, 192, 2, 64, 16), (2, 64, 2, 32, 32), (3, 100, 2, 32, 16),
              (1, 160, 2, 32, 16)]
    cases = [("test shape", s, "float32", False) for s in shapes]
    cases += [("test shape", s, "bfloat16", False) for s in shapes[:2]]
    # ragged S, P 16 and 32, N off the kernel's 64 columns, N 256, and the
    # strided views of one conv output that ssm_apply passes
    cases += [(label, shape, "bfloat16", views) for label, shape, views in (
        ("ragged S", (2, 300, 4, 64, 128), False),
        ("ragged S, P 32, N 48", (3, 37, 3, 32, 48), False),
        ("P 16, N 256", (1, 130, 2, 16, 256), False),
        ("conv-output views", (2, 300, 4, 64, 128), True))]
    return cases + [("serving prefill", SSD_SERVING, dt, views)
                    for dt, views in (("float32", False),
                                      ("bfloat16", False),
                                      ("bfloat16", True))]


def _ssd_inputs(seed, shape, dtype, device, views=False):
    """x, dt (post-softplus), A (positive), Bm, Cm as the reference's
    tests draw them; x, Bm, Cm in `dtype`, with `views` as the views of
    one [B, S, H P + 2 N] buffer (the conv output `ssm_apply` splits)."""
    import torch
    import torch.nn.functional as F
    B, S, H, P, N = shape
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*s):
        return torch.randn(s, generator=g, device=device)
    x = randn(B, S, H, P) * 0.5
    dt = F.softplus(randn(B, S, H))
    A = randn(H).abs() + 0.1
    Bm, Cm = randn(B, S, N) * 0.3, randn(B, S, N) * 0.3
    low = getattr(torch, dtype)
    x, Bm, Cm = x.to(low), Bm.to(low), Cm.to(low)
    if views:
        buf = torch.cat([x.reshape(B, S, H * P), Bm, Cm], -1)
        di = H * P
        x, Bm, Cm = (buf[..., :di].reshape(B, S, H, P), buf[..., di:di + N],
                     buf[..., di + N:])
    return x, dt, A, Bm, Cm


def phase_ssd_scan(device):
    """The kernels against `ssd_ref` on the card for every case, each on
    the kernel the rule names; returns (max abs error, the bf16 serving
    shape's inputs).  fp32: y and the final state within 1e-4 of their
    largest value; bf16: y per output row (one (b, t, h) over P), as phase
    7 holds attention, and the state within 1e-4."""
    import torch
    from repro_torch.kernels.ssd_scan import ops, ssd_chunk_ref, ssd_ref
    worst, timed = 0.0, None
    for i, (label, shape, dtype, views) in enumerate(_ssd_cases()):
        args = _ssd_inputs(100 + i, shape, dtype, device, views)
        before = dict(ops.ssd_scan.launches_by_kernel)
        y, state = ops.ssd_scan(*args, return_state=True)
        want_y, want_s = ssd_ref(*args)
        torch.cuda.synchronize()
        ran = [name for name, n in ops.ssd_scan.launches_by_kernel.items()
               if n != before[name]]
        kernel = ops.kernel_for(args[0].dtype, shape[3], shape[4])
        check(ran == [kernel], f"ssd_scan {label}: ran {ran}, the rule names "
                               f"{kernel}")
        check(y.dtype == args[0].dtype and y.shape == args[0].shape,
              f"ssd_scan {label}: y {y.dtype} {tuple(y.shape)}")
        check(bool(torch.isfinite(y).all() and torch.isfinite(state).all()),
              f"ssd_scan {label}: non-finite output")
        if dtype == "float32":
            diff = float((y - want_y).abs().max())
            rel = diff / float(want_y.abs().max())
        else:
            diff, rel = _row_rel(y, want_y)
        sdiff = float((state - want_s).abs().max())
        srel = sdiff / float(want_s.abs().max())
        check(rel < SSD_TOL[dtype], f"ssd_scan {label} {dtype}: y relative "
                                    f"error {rel} >= {SSD_TOL[dtype]}")
        check(srel < 1e-4, f"ssd_scan {label} {dtype}: state relative error "
                           f"{srel} >= 1e-4")
        worst = max(worst, diff, sdiff)
        note = ""
        if shape == SSD_SERVING and dtype == "bfloat16" and not views:
            # beside its own decomposition with the same roundings
            cy, cs = ssd_chunk_ref(*args, chunk=64, rounding=True)
            note = (f"; against ssd_chunk_ref with its roundings: y "
                    f"{_row_rel(y, cy)[1]:.3e} per row, state "
                    f"{float((state - cs).abs().max() / cs.abs().max()):.3e}")
            del cy, cs
            timed = args
        print(f"[ssd_scan] {label} {shape} {dtype}{' views' * views}: "
              f"{kernel} kernel == ssd_ref (y max abs {diff:.3e}, "
              f"relative{' per row' * (dtype != 'float32')} {rel:.3e}; state "
              f"max abs {sdiff:.3e}, relative {srel:.3e}){note}")
    return worst, timed


def ssd_ops_count(shape, chunk=128):
    """Operations of the chunked SSD at `chunk` over causal pairs only:
    per (b, h, chunk of L) (N + P) L (L + 1) for C B^T and its product with
    x, and 4 L P N for the inter-chunk term and the state update."""
    B, S, H, P, N = shape
    total = 0
    for t0 in range(0, S, chunk):
        L = min(chunk, S - t0)
        total += (N + P) * L * (L + 1) + 4 * L * P * N
    return B * H * total


def ssd_fma_kernel(x, dt, A, Bm, Cm):
    """The FMA kernel (csrc/ssd_scan.cu) launched on bf16 inputs that the
    dispatch rule sends to the tensor-core kernel: the yardstick of the
    earlier design, timed beside it and used nowhere else."""
    import torch
    from repro_torch.kernels.ssd_scan import ops
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    y = torch.empty_like(x)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    rc = ops.library().ssd_scan_fwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), y.data_ptr(), state.data_ptr(), 1, B, S, H, P, N,
        torch.cuda.current_stream().cuda_stream)
    check(rc == 0, f"FMA ssd_scan kernel launch failed: CUDA error {rc}")
    return y, state


def phase_ssd_timing(args):
    """The tensor-core kernel, the FMA kernel on the same bf16 inputs and
    the plain version at the served shape, against the bound: the bytes of
    x, dt, B, C read once and y, the state written once at 3.35 TB/s, or
    the chunked form's operations (chunk 128, causal pairs) at 989.4
    TFLOP/s, whichever is larger."""
    from repro_torch.kernels.ssd_scan import ops, ssd_ref
    x, dt, A, Bm, Cm = args
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    ms = cuda_ms(lambda: ops.ssd_scan(*args, return_state=True), 20)
    fma_ms = cuda_ms(lambda: ssd_fma_kernel(*args), 5)
    plain_ms = cuda_ms(lambda: ssd_ref(*args), 2)
    nbytes = sum(t.numel() * t.element_size() for t in args) \
        + x.numel() * x.element_size() + B * H * P * N * 4
    ops_count = ssd_ops_count((B, S, H, P, N))
    ops_ms = ops_count / H100_BF16_OPS_PER_S * 1e3
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    print(f"[ssd_scan] B={B} S={S} H={H} P={P} N={N} {x.dtype}: "
          f"{ops.kernel_for(x.dtype, P, N)} kernel {ms:.4f} ms/launch "
          f"({bound_ms / ms:.3f} of the bound), the FMA kernel on the same "
          f"bf16 inputs {fma_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms * 1e3:.2f} us ({ops_count} operations: "
          f"{ops_ms * 1e3:.2f} us at 989.4 TFLOP/s; {nbytes} bytes: "
          f"{bytes_ms * 1e3:.2f} us at 3.35 TB/s); library call: none")
    check(ms < fma_ms, f"ssd_scan: the tensor-core kernel ({ms:.4f} ms) is "
                       f"not faster than the FMA kernel ({fma_ms:.4f} ms)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                library_ms=None, fma_ms=fma_ms)


RGLRU_SERVING = (SERVE_BATCH, 4096, 2560)


def _rglru_inputs(seed, shape, device, const=None, offset=0):
    """a in [0.79, 0.99] and b normal * 0.1 as the reference's sweep
    draws them, or the constants `const` = (a, b); with `offset`, views
    that start `offset` elements into their buffers."""
    import torch
    n = int(np.prod(shape)) + offset
    if const is not None:
        a, b = (torch.full((n,), c, device=device) for c in const)
    else:
        g = torch.Generator(device=device).manual_seed(seed)
        a = torch.sigmoid(torch.randn(n, generator=g, device=device)) \
            * 0.2 + 0.79
        b = torch.randn(n, generator=g, device=device) * 0.1
    return tuple(x[offset:].view(shape) for x in (a, b))


# (label, shape, constants, base offset in elements); the serving shape last
RGLRU_CASES = (
    ("sweep", (1, 128, 128), None, 0), ("sweep", (2, 300, 192), None, 0),
    ("sweep", (2, 64, 512), None, 0),
    ("long decay a = 0.999", (1, 2048, 128), (0.999, 0.01), 0),
    ("S 1, R 37", (4, 1, 37), None, 0), ("S 37, R 100", (1, 37, 100), None, 0),
    ("S 300, R 37", (4, 300, 37), None, 0),
    ("S 300, R 100", (1, 300, 100), None, 0),
    ("S 37", (4, 37, 2560), None, 0),
    ("base off 16 bytes (4-byte copies)", (2, 64, 512), None, 1),
    ("serving prefill", RGLRU_SERVING, None, 0))


def phase_rglru(device):
    """Each case on the kernel the rule names (the ring kernel), bit for
    bit against the direct kernel on the same inputs and against
    `rglru_scan_ref` at 1e-5 of the largest value, the reference's bar;
    returns (max abs error, the serving shape's inputs)."""
    import torch
    from repro_torch.kernels.rglru import ops, rglru_scan_ref
    kernel = ops.kernel_for()
    check(kernel == "ring", f"rglru: the rule names {kernel!r}")
    worst = 0.0
    for i, (label, shape, const, offset) in enumerate(RGLRU_CASES):
        a, b = _rglru_inputs(200 + i, shape, device, const, offset)
        before = dict(ops.rglru_scan.launches_by_kernel)
        got = ops.rglru_scan(a, b)
        torch.cuda.synchronize()
        by_kernel = dict(ops.rglru_scan.launches_by_kernel)
        check(by_kernel == dict(before, ring=before["ring"] + 1),
              f"rglru {label}: launches by kernel {before} -> {by_kernel}, "
              f"want one more on the ring kernel")
        direct = ops.rglru_scan(a, b, kernel="direct")
        want = rglru_scan_ref(a, b)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"rglru {label}: non-finite")
        check(torch.equal(got, direct),
              f"rglru {label} {shape}: the ring kernel != the direct kernel "
              f"(max abs {float((got - direct).abs().max()):.3e})")
        diff = float((got - want).abs().max())
        rel = diff / float(want.abs().max())
        check(rel < 1e-5, f"rglru {label} {shape}: relative error {rel}")
        worst = max(worst, diff)
        print(f"[rglru] {label} {shape}: ring kernel == direct kernel bit "
              f"for bit; vs rglru_scan_ref max abs {diff:.3e}, relative "
              f"{rel:.3e}")
    return worst, (a, b)


def phase_rglru_timing(a, b):
    """The ring kernel, the direct kernel and the plain version on the same
    inputs at the served shape, against the bound: a and b read once and h
    written once at 3.35 TB/s."""
    from repro_torch.kernels.rglru import ops, rglru_scan_ref
    B, S, R = a.shape
    ms = cuda_ms(lambda: ops.rglru_scan(a, b), 20)
    direct_ms = cuda_ms(lambda: ops.rglru_scan(a, b, kernel="direct"), 20)
    plain_ms = cuda_ms(lambda: rglru_scan_ref(a, b), 2)
    nbytes = 3 * a.numel() * a.element_size()
    bound_ms = nbytes / H100_BYTES_PER_S * 1e3
    print(f"[rglru] B={B} S={S} R={R} fp32: ring kernel {ms:.4f} ms/launch "
          f"({bound_ms / ms:.3f} of the bound), the direct kernel on the "
          f"same inputs {direct_ms:.4f} ms ({bound_ms / direct_ms:.3f}), "
          f"plain {plain_ms:.4f} ms, bound {bound_ms * 1e3:.2f} us "
          f"({nbytes} bytes at 3.35 TB/s; {2 * a.numel()} operations, "
          f"nothing beside them); library call: none")
    check(ms < direct_ms, f"rglru: the ring kernel ({ms:.4f} ms) is not "
                          f"faster than the direct kernel ({direct_ms:.4f} "
                          f"ms)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes", library_ms=None, direct_ms=direct_ms)


def expected_launches(cfg):
    """The LM kernels' launches in one prefill: one a layer of its kind,
    the encoder's (non-causal) attention layers included."""
    kinds = [cfg.block_pattern[i % len(cfg.block_pattern)]
             for i in range(cfg.num_layers)] + ["enc"] * cfg.encoder_layers
    return {"flash_attention": sum(k in ("attn", "local", "enc")
                                   for k in kinds),
            "ssd_scan": kinds.count("ssm"), "rglru": kinds.count("rglru")}


def head_of(batch, n):
    """`batch` with its tokens and source frames cut to the first `n`."""
    return {k: v[:, :n] if k in ("tokens", "src_embeds") else v
            for k, v in batch.items()}


def on_device(batch, device):
    """`batch` as tensors on `device` (tokens int32)."""
    import torch
    return {k: torch.as_tensor(v, dtype=torch.int32 if k == "tokens"
                               else None).to(device)
            for k, v in batch.items()}


def phase_serve(device, arch, S, profile=False):
    """One model's serving path at full width, timed over `SERVE_SAMPLES`
    `generate` calls, each holding the LM kernels' launches to one a layer
    of the kernel's kind, every flash_attention and ssd_scan launch on the
    kernel the rule names; returns the launches of one `generate` (the
    last).  The inputs are the serve command line's (`draw_batch`: a
    vision model's prefix rows, an encoder-decoder's S source frames).
    With `profile`, then traces a prefill and a few decode steps."""
    import statistics
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rglru import ops as rglru_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch.serve import draw_batch, generate
    from repro_torch.models import transformer as TF
    cfg = get_config(arch)
    B, gen = SERVE_BATCH, SERVE_GEN
    t0 = time.perf_counter()
    model = TF.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                           device=device)
    torch.cuda.synchronize()
    print(f"[serve] {cfg.name}: {cfg.num_params()} parameters (num_params), "
          f"{sum(p.numel() for p in model.parameters())} in the module, "
          f"{cfg.dtype}, init on the card {time.perf_counter() - t0:.2f} s")
    batch = on_device(draw_batch(cfg, B, S), device)
    print(f"[serve] {arch} inputs: " + ", ".join(
        f"{k} {tuple(v.shape)} {v.dtype}" for k, v in batch.items()))
    # warm-up: the first bf16 products load their cuBLAS kernels
    generate(model, cfg, head_of(batch, 128), 2, prefill_impl="kernel",
             device=device)
    torch.cuda.reset_peak_memory_stats()
    kernels = _lm_kernels()
    # the kernel each bf16 prefill launch runs: attention at the model's hd
    # (llama 128, recurrentgemma 256) and mamba2's scan on the tensor cores,
    # recurrentgemma's fp32 RG-LRU scan on the ring kernel
    rules = {}
    if expected_launches(cfg)["flash_attention"]:
        rules["flash_attention"] = fa_ops.kernel_for(cfg.torch_dtype, cfg.hd)
    if cfg.ssm is not None:
        rules["ssd_scan"] = ssd_ops.kernel_for(
            cfg.torch_dtype, cfg.ssm.head_dim, cfg.ssm.d_state)
    if expected_launches(cfg)["rglru"]:
        rules["rglru"] = rglru_ops.kernel_for()
    prefill_ms, decode_ms = [], []
    for _ in range(SERVE_SAMPLES):
        _reset_launches()
        out, prefill_s, step_ms = generate(
            model, cfg, batch, gen, prefill_impl="kernel", device=device)
        launches = {name: fn.launches for name, fn in kernels.items()}
        check(tuple(out.shape) == (B, gen),
              f"generated shape {tuple(out.shape)}")
        check(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
              "a generated token outside [0, V)")
        check(launches == expected_launches(cfg),
              f"{arch}: launches {launches} in one prefill, want "
              f"{expected_launches(cfg)} (one a layer of the kernel's kind)")
        for name in ("flash_attention", "ssd_scan", "rglru"):
            kernel = rules.get(name)
            by_kernel = dict(kernels[name].launches_by_kernel)
            want = {k: launches[name] * (k == kernel) for k in by_kernel}
            check(by_kernel == want, f"{arch}: {name} launches by kernel "
                                     f"{by_kernel}, want {want}")
            launches[f"{name}_by_kernel"] = by_kernel
        prefill_ms.append(prefill_s * 1e3)
        decode_ms.append(step_ms)
    peak = torch.cuda.max_memory_allocated()

    def spread(xs):
        return (f"median {statistics.median(xs):.2f} (min {min(xs):.2f}, "
                f"max {max(xs):.2f}; {', '.join(f'{x:.2f}' for x in xs)})")
    prefill = statistics.median(prefill_ms) / 1e3
    decode = statistics.median(decode_ms)
    extra = "".join(f", {k} rows {v.shape[1]}" for k, v in batch.items()
                    if k != "tokens")
    print(f"[serve] {arch} batch {B}, prompt {S}{extra}, {gen} tokens, "
          f"{SERVE_SAMPLES} samples: prefill ms {spread(prefill_ms)}, "
          f"{B * S / prefill:.1f} tokens/s at the median; decode ms/token "
          f"{spread(decode_ms)}, {B * 1e3 / decode:.1f} tokens/s at the "
          f"median; launches {launches}; max_memory_allocated {peak} bytes")
    print(f"[serve] {arch} tokens[0]: {out[0].tolist()}")
    if profile:
        phase_serve_profile(model, cfg, batch, device)
    tokens = batch["tokens"].cpu().numpy()
    if cfg.moe is not None:
        launches["moe_dropped_share"] = check_moe_against_naive(
            model, cfg, tokens, device)
    else:
        check_against_naive(model, cfg, batch, device)
    if cfg.ssm is not None or cfg.rglru is not None or cfg.frontend \
            or cfg.encoder_layers:
        # the scans' algorithm and the state handoff, the prefix rows in
        # the cache and the encoder's memory, free of bf16 rounding, over
        # the whole model
        torch.cuda.empty_cache()
        model.float()
        torch.cuda.reset_peak_memory_stats()
        check_against_naive(model, dataclasses.replace(cfg, dtype="float32"),
                            batch, device)
        print(f"[serve] {arch} float32 check: max_memory_allocated "
              f"{torch.cuda.max_memory_allocated()} bytes")
    if cfg.moe is not None:
        # the MoE path, its drops and the caches free of bf16 rounding, at
        # full depth (16.4 B parameters: 65.4 GB in fp32); the decode check
        # on one row (with no drops, 4.4 GB a buffer at B 4 would not fit)
        torch.cuda.empty_cache()
        model.float()
        torch.cuda.reset_peak_memory_stats()
        check_moe_against_naive(model, dataclasses.replace(
            cfg, dtype="float32"), tokens, device, decode_rows=1)
        print(f"[serve] {arch} float32 check: max_memory_allocated "
              f"{torch.cuda.max_memory_allocated()} bytes")
    del model
    torch.cuda.empty_cache()
    return launches


def no_drop(cfg):
    """`cfg` with an MoE capacity factor of E / K, which makes the capacity
    T: no (token, slot) pair is ever dropped."""
    moe = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        moe, capacity_factor=moe.num_experts / moe.top_k))


@contextlib.contextmanager
def moe_routing(replay=None):
    """Within it, every router call of the port's MoE layers appends its
    top-k picks [T, K] and kept mask [T*K] to the yielded list, in call
    order.  With `replay` (such picks, one a call in the same order), each
    call takes those picks instead of its own: its gates are still its own
    probabilities at them, and `route` still counts positions and drops
    from them with its own capacity."""
    from repro_torch.models import moe
    route, top_k = moe.route, moe.top_k
    record = []

    def recording_route(p, xt, mcfg):
        out = route(p, xt, mcfg)
        record.append((out[1], out[3]))
        return out

    def pinned_top_k(probs, k):
        idx = replay[len(record)]
        check(tuple(idx.shape) == (*probs.shape[:-1], k),
              f"replayed picks {tuple(idx.shape)} for probs "
              f"{tuple(probs.shape)}, k {k}")
        return probs.gather(-1, idx), idx
    moe.route = recording_route
    if replay is not None:
        moe.top_k = pinned_top_k
    try:
        yield record
    finally:
        moe.route, moe.top_k = route, top_k


def check_moe_against_naive(model, cfg, tokens, device, gen=SERVE_GEN,
                            decode_rows=None):
    """An MoE model's served path against a naive full forward, last
    position, each run twice: with the served path's expert picks
    replayed in the naive forward (held as below), and free (reported
    with the token-layers whose expert set changed: in bf16 the two
    forwards' roundings flip routers near a tie, each flip moving a token
    by a whole expert).  The prefill runs at the model's capacity against
    a naive forward over the same S tokens, so both have the same T and
    capacity and drop the same pairs (checked); the decode step's forward
    has S + 1 tokens and so another capacity, so it runs with no drops
    (`no_drop`) on both sides.  fp32: within 1e-3.  bf16: within 2e-2, or
    twice the naive forward's own move when only its attention's order of
    sums changes (chunked attention, the same picks replayed) if that is
    larger, as for mamba2 in `check_against_naive`: a random-weight
    deepseek-moe-16b amplifies its bf16 roundings over 28 layers.  With
    `decode_rows`, the decode check runs on that many rows of the batch:
    with no drops an expert's buffer holds every token, [E + 1, T, D].
    Returns the share of (token, slot) pairs the served prefill
    dropped."""
    import torch
    from repro_torch.models import transformer as TF
    from repro_torch.models.moe import capacity
    arch, B, S = cfg.name, *tokens.shape
    bf16 = cfg.dtype != "float32"

    def last(c, toks, replay=None, attn="naive"):
        with moe_routing(replay) as rt:
            logits = TF.forward(model, c, {"tokens": toks}, "train",
                                attn_impl=attn)[0]
        return logits[:, -1].float(), rt

    def held(what, served, c, toks, picks):
        check(bool(torch.isfinite(served).all()),
              f"{arch} {cfg.dtype} {what}: non-finite logits")
        pinned, _ = last(c, toks, picks)
        free, free_rt = last(c, toks)
        changed = sum(
            int((x.sort(-1).values != y.sort(-1).values).any(-1).sum())
            for x, (y, _) in zip(picks, free_rt))
        rel, free_rel = _rel(served, pinned), _rel(served, free)
        bar, note = 1e-3, ""
        if bf16:
            spread = _rel(last(c, toks, picks, "chunked")[0], pinned)
            bar = max(2e-2, 2 * spread)
            note = (f" (the naive forward with chunked attention and the "
                    f"same picks: {spread:.3e}; within 2e-2: {rel < 2e-2})")
        check(rel < bar, f"{arch} {cfg.dtype} {what} logits vs naive full "
                         f"forward with the served picks: relative {rel} "
                         f">= {bar}")
        print(f"[serve] {arch} {cfg.dtype} {what} logits vs a naive full "
              f"forward, last position: with the served expert picks "
              f"relative {rel:.3e}{note}, bar {bar:.3e}; free picks "
              f"{free_rel:.3e} ({changed} token-layers picked another "
              f"expert set)")

    with torch.inference_mode():
        prompt = torch.as_tensor(tokens, dtype=torch.int32, device=device)
        with moe_routing() as served_rt:
            logits = TF.forward(model, cfg, {"tokens": prompt}, "prefill",
                                cache=TF.init_cache(cfg, B, S + gen,
                                                    device=device),
                                attn_impl="kernel")[0]
        served = logits[:, -1].float()
        del logits
        picks = [i for i, _ in served_rt]
        _, pinned_rt = last(cfg, prompt, picks)
        check(all(torch.equal(a, b) for (_, a), (_, b)
                  in zip(served_rt, pinned_rt)),
              f"{arch}: the naive forward with the served picks dropped "
              f"other pairs")
        del pinned_rt
        held("prefill (kernel)", served, cfg, prompt, picks)
        routed = sum(k.numel() for _, k in served_rt)
        dropped = sum(int((~k).sum()) for _, k in served_rt)

        nd = no_drop(cfg)
        prompt = prompt[:decode_rows]
        B = prompt.shape[0]
        with moe_routing() as rt:
            cache = TF.init_cache(nd, B, S + gen, device=device)
            logits, cache, _ = TF.forward(model, nd, {"tokens": prompt},
                                          "prefill", cache=cache,
                                          attn_impl="kernel")
            nxt = torch.argmax(logits[:, -1:], dim=-1).int()
            del logits
            logits, cache, _ = TF.forward(model, nd, {"tokens": nxt},
                                          "decode", cache=cache)
        served = logits[:, -1].float()
        del logits, cache
        L, K = len(rt) // 2, cfg.moe.top_k
        picks = [torch.cat([rt[i][0].view(B, S, K),
                            rt[L + i][0].view(B, 1, K)], 1).view(-1, K)
                 for i in range(L)]
        held("decode step", served, nd, torch.cat([prompt, nxt], 1), picks)
    moe, B = cfg.moe, tokens.shape[0]
    print(f"[serve] {arch} {cfg.dtype} prefill: {dropped} of {routed} "
          f"(token, slot) pairs dropped by the capacity "
          f"({dropped / routed:.4%}; {len(served_rt)} MoE layers, "
          f"{capacity(B * S, moe)} slots an expert for "
          f"{B * S * moe.top_k / moe.num_experts:.0f} pairs on average)")
    return dropped / routed


def served_and_naive(model, cfg, batch, device, gen=SERVE_GEN):
    """Last-position logits of (a kernel prefill of `batch` (tokens [B, S],
    a vision model's prefix rows, an encoder-decoder's source frames) into
    a cache as generate sizes it, then one decode step of its greedy
    token), and of one naive forward over the same prefix or source, the
    prompt and that token, at token positions S-1 and S."""
    import torch
    from repro_torch.launch.serve import cache_len, decode_extra
    from repro_torch.models import transformer as TF
    prompt = batch["tokens"]
    B, S = prompt.shape
    with torch.inference_mode():
        cache = TF.init_cache(cfg, B, cache_len(cfg, S, gen), device=device)
        logits, cache, _ = TF.forward(model, cfg, batch, "prefill",
                                      cache=cache, attn_impl="kernel")
        served = [logits[:, -1].float()]
        nxt = torch.argmax(logits[:, -1:], dim=-1).int()
        del logits
        logits, cache, _ = TF.forward(
            model, cfg, {"tokens": nxt, **decode_extra(cfg, batch)},
            "decode", cache=cache)
        served.append(logits[:, -1].float())
        del logits, cache
        full = dict(batch, tokens=torch.cat([prompt, nxt], 1))
        logits, _, _ = TF.forward(model, cfg, full, "train",
                                  attn_impl="naive")
        naive = [logits[:, -2].float(), logits[:, -1].float()]
        del logits
        control = None
        if cfg.ssm is not None:
            # the plain forward against itself with only its chunk (the
            # order of its fp32 sums) changed
            half = dataclasses.replace(cfg, ssm=dataclasses.replace(
                cfg.ssm, chunk=cfg.ssm.chunk // 2))
            logits, _, _ = TF.forward(model, half, full, "train",
                                      attn_impl="naive")
            control = [logits[:, -2].float(), logits[:, -1].float()]
            del logits
    return served, naive, control


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def check_against_naive(model, cfg, batch, device):
    """The served path's prefill and first decode step against a naive
    full forward, last position.  fp32: within 1e-3.  bf16: within 2e-2,
    or twice the plain forward's own move when only its SSD chunk changes
    if that is larger (a random-weight mamba2-780m in bf16 moves 0.26 so,
    its bf16 roundings amplified over 48 layers; the fp32 check holds the
    same path to 1e-3)."""
    import torch
    arch = cfg.name
    served, naive, control = served_and_naive(model, cfg, batch, device)
    for i, what in enumerate(("prefill (kernel)", "decode step")):
        check(bool(torch.isfinite(served[i]).all()),
              f"{arch} {cfg.dtype} {what}: non-finite logits")
        rel = _rel(served[i], naive[i])
        if cfg.dtype == "float32":
            bar, note = 1e-3, ""
        else:
            spread = 0.0 if control is None else _rel(control[i], naive[i])
            bar = max(2e-2, 2 * spread)
            note = ("" if control is None else
                    f" (the naive forward at chunk {cfg.ssm.chunk // 2}: "
                    f"{spread:.3e})")
        check(rel < bar, f"{arch} {cfg.dtype} {what} logits vs naive full "
                         f"forward: relative {rel} >= {bar}")
        print(f"[serve] {arch} {cfg.dtype} {what} logits vs a naive full "
              f"forward, last position: relative {rel:.3e}{note}, bar "
              f"{bar:.3e}")


def phase_lm_parity(device, arch):
    """A smoke model in fp32 with the same weights and inputs (the serve
    command line's: a vision model's prefix rows, an encoder-decoder's
    source frames) on the card and on the CPU: equal greedy tokens,
    prefill logits within 1e-4 relative."""
    import copy
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import cache_len, draw_batch, generate
    from repro_torch.models import transformer as TF
    cfg = dataclasses.replace(get_config(arch + "-smoke"), dtype="float32")
    cpu = TF.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    card = copy.deepcopy(cpu).to(device)
    inputs = draw_batch(cfg, 2, 64, seed=1)
    runs = [(card, device), (cpu, "cpu")]
    outs = [generate(m, cfg, inputs, 8, prefill_impl="kernel",
                     device=d)[0].cpu() for m, d in runs]
    check(torch.equal(outs[0], outs[1]), f"{cfg.name}: CUDA tokens != CPU")
    logits = []
    with torch.inference_mode():
        for m, d in runs:
            cache = TF.init_cache(cfg, 2, cache_len(cfg, 64, 0), device=d)
            logits.append(TF.forward(m, cfg, on_device(inputs, d), "prefill",
                                     cache=cache, attn_impl="kernel")[0].cpu())
    rel = float((logits[0] - logits[1]).abs().max() / logits[1].abs().max())
    check(rel < 1e-4, f"{cfg.name}: CUDA logits vs CPU relative {rel}")
    print(f"[lm-parity] {cfg.name} fp32: 8 greedy tokens CUDA == CPU "
          f"{outs[0][0].tolist()}; prefill logits relative {rel:.3e}")


# phase 12: Fig. 11's grid at paper scale (radix-16, g = 41), its cycles
# cut from 2,000 + 8,000 to these; the small scenarios the card runs
# against the CPU
FIG11_CUT = dict(warmup=300, measure=1200)
EXP_SMALL = ("smoke", "smoke_fused", "smoke_compact", "smoke_faults",
             "smoke_warm_faults")
EXP_TIMINGS = ("wall_s", "compile_s")
# phase 13: the windowed cell and the service
WINDOW = 128
WINDOW_K = (1, 4)
SERVE_SUBS = (("alice", "smoke"), ("bob", "smoke"),
              ("carol", "smoke_faults"), ("dave", "smoke_warm_faults"))
SERVE_WINDOW = 100


def _jsonl(path):
    return Path(path).read_text().splitlines()


def _strip(rows):
    return [{k: v for k, v in r.items() if k not in EXP_TIMINGS}
            for r in rows]


def phase_exp(device):
    """Fig. 11's grid at paper scale through `repro_torch.exp.run.main`
    (cycles cut, printed), run twice: one capture a grid, then none;
    packet conservation on every lane; the switch-less 1B uniform cell
    equal to `Simulator.sweep_grid`; per cell cycles/s, capture seconds
    and the memory held with the cells' graphs cached.  Then the small
    scenarios on the card against the CPU, row for row.  Returns the
    numbers, the fig11 spec and its grids."""
    import torch
    from repro_torch.core.engine import graphs
    from repro_torch.core.engine import sweep as SW
    from repro_torch.core.simulator import Simulator
    from repro_torch.exp import registry, runner
    from repro_torch.exp.run import main as run_main
    full = registry.fig11_spec(fast=False)
    spec = full.with_axes(**FIG11_CUT)
    out_dir = ROOT / "build" / "exp"
    out_dir.mkdir(parents=True, exist_ok=True)
    spec_path = out_dir / "fig11_g41.json"
    spec_path.write_text(json.dumps(spec.to_dict()))
    cycles = spec.axes.warmup + spec.axes.measure
    net = spec.topologies[0].build()
    print(f"[exp] fig11 (fast=False): {spec.num_grids} grids x "
          f"{spec.axes.lanes_per_grid} lanes, g = {net.meta['g']} "
          f"({net.num_chips} chips, {net.num_channels} channels "
          f"switch-less 1B); cycles cut from "
          f"{full.axes.warmup} + {full.axes.measure} to "
          f"{spec.axes.warmup} + {spec.axes.measure} ({spec_path})")
    fresh_peak()
    t0 = time.perf_counter()
    cell_list = list(runner.cells(spec))
    probes = [ConservationProbe(runner.cell_sweep(c, spec.axes, device),
                                spec.axes.warmup, cycles - 1)
              for c in cell_list]
    setup_s = time.perf_counter() - t0
    base = torch.cuda.memory_allocated()
    args = ["--spec", str(spec_path), "--quiet",
            "--out", str(out_dir / "fig11_g41.json.out"),
            "--jsonl", str(out_dir / "fig11_g41.jsonl")]
    rc, wall, dev1, _ = counted(lambda: run_main(args, device=device))
    check(rc == 0, f"fig11 run exited {rc}")
    held = dict(memory_allocated=torch.cuda.memory_allocated(),
                max_memory_allocated=torch.cuda.max_memory_allocated(),
                memory_reserved=torch.cuda.memory_reserved(),
                graphs_cached=len(graphs._GRAPHS), before=base)
    first = json.loads((out_dir / "fig11_g41.json.out").read_text())
    check(first["compile_counts"] == [1] * spec.num_grids,
          f"fig11 first run captures {first['compile_counts']}")
    captured = list(graphs._GRAPHS.values())[-spec.num_grids:]
    before = SW.compile_counter()
    again, wall2, dev2, _ = counted(
        lambda: runner.run_experiment(spec, device=device))
    check(again.compile_counts == [0] * spec.num_grids
          and SW.compile_counter() == before,
          f"fig11 second run captured {again.compile_counts}")
    rows1 = [{k: v for k, v in r.items() if k not in EXP_TIMINGS
              + ("compile_count",)} for r in first["rows"]]
    rows2 = [{k: v for k, v in r.items() if k not in EXP_TIMINGS
              + ("compile_count", "avg_hops_by_type")} for r in again.rows()]
    check(rows1 == rows2, "fig11: the second run's rows != the first's")
    results = [r for r in map(json.loads, _jsonl(out_dir / "fig11_g41.jsonl"))
               if r["kind"] == "result"]
    R = len(spec.axes.rates)
    cells_out = []
    for gi, (g, probe, graph) in enumerate(zip(again.grids, probes,
                                               captured)):
        tag = f"exp {g.topology.label} {g.traffic.label}"
        probe.check_lanes(g.sweep_result(0), tag)
        for ri, res in enumerate(g.results[0]):
            rec = results[gi * R + ri]
            check(rec["delivered_pkts"] == res[0].delivered_pkts
                  and rec["throughput"] == res[0].throughput_per_chip
                  and rec["hops_by_type"] == res[0].hops_by_type,
                  f"{tag}: JSONL lane {ri} != the second run")
        grid_wall = sum(r["wall_s"] for r in first["rows"][gi * R:
                                                           (gi + 1) * R])
        cells_out.append(dict(
            topology=g.topology.label, pattern=g.traffic.label,
            lanes=R, cycles_per_s=cycles / grid_wall,
            again_cycles_per_s=cycles / g.wall_s,
            capture_s=graph.capture_s, superstep=graph.K))
        print(f"[exp]   {tag}: {R} lanes x {cycles} cycles, "
              f"{cycles / grid_wall:.2f} cycles/s (second run "
              f"{cycles / g.wall_s:.2f}), capture {graph.capture_s:.3f} s "
              f"(K {graph.K})")
    cell = cell_list[0]
    check((cell.topology.label, cell.traffic.pattern) ==
          ("switchless-1B", "uniform"), "fig11's first cell")
    sim = Simulator(cell.net, cell.cfg, cell.pattern, device=device)
    ref = sim.sweep_grid(list(spec.axes.rates), list(spec.axes.seeds))
    check([dataclasses.asdict(r) for r in ref.flat()]
          == [dataclasses.asdict(r) for r in again.grids[0].sweep_result(0)
              .flat()],
          "fig11 switch-less 1B uniform != Simulator.sweep_grid")
    print(f"[exp] fig11 switchless-1B uniform == Simulator.sweep_grid on "
          f"all {R} lanes, field for field")
    expect = spec.num_grids * cycles
    check(dev1["grant"]["coop"] == expect + spec.num_grids
          and dev2["grant"]["coop"] == expect
          and not any(dev1["cycle_core"].values()),
          f"fig11 grant launches {dev1['grant']} / {dev2['grant']} != "
          f"{expect} + one warm-up a capture")
    print(f"[exp] fig11: wall {wall:.2f} s (set-up {setup_s:.2f} s), "
          f"second run {wall2:.2f} s; grant launches on the card "
          f"{dev1['grant']} then {dev2['grant']}; with the {spec.num_grids} "
          f"cells' graphs cached: memory_allocated "
          f"{held['memory_allocated']}, max_memory_allocated "
          f"{held['max_memory_allocated']}, memory_reserved "
          f"{held['memory_reserved']} bytes (before {base})")
    small = {}
    for name in EXP_SMALL:
        scen = registry.get_scenario(name)
        card, _, dev, _ = counted(
            lambda: runner.run_experiment(scen, device=device))
        cpu = runner.run_experiment(scen, device="cpu")
        check(_strip(card.rows()) == _strip(cpu.rows()),
              f"exp {name}: CUDA rows != CPU rows")
        small[name] = dev
        print(f"[exp] {name}: {len(card.rows())} rows CUDA == CPU, every "
              f"field; captures {card.compile_counts}, escalations "
              f"{[g.escalations for g in card.grids]}; launches on the "
              f"card {dev}")
    launches = {w: {k: sum(d[w][k] for d in small.values())
                    for k in dev1[w]} for w in dev1}
    return dict(fig11=dict(cells=cells_out, memory=held, wall_s=wall,
                           launches=dev1, second_run_launches=dev2,
                           spec_path=str(spec_path),
                           captures=sum(first["compile_counts"])),
                small_launches=launches), spec, again


def phase_windows(device, spec, grids):
    """The fig11 switch-less 1B uniform cell (g = 41, 1,500 cycles) as a
    `LaneSession` at window 128, at K = 1 and 4: `finish()` equals the
    one-shot grid; at K = 1 an `export()` after window 5, restored into a
    fresh session, equals it too.  Each K's windowed cycles/s beside a
    one-shot run of the same lanes on the same graph, and the host's time
    to draw the run's key chain.  Returns the numbers and launches."""
    import torch
    from repro_torch.core.engine.step import _key_chain
    from repro_torch.core.engine.sweep import BatchedSweep
    from repro_torch.exp import runner
    cell = next(runner.cells(spec))
    cycles = spec.axes.warmup + spec.axes.measure
    lanes = [(r, s, None) for r in spec.axes.rates for s in spec.axes.seeds]
    want = [dataclasses.asdict(r) for r in grids.grids[0].sweep_result(0)
            .flat()]
    sweep = BatchedSweep(cell.net, cell.cfg, cell.pattern, device=device)
    keys = sweep._prepare_lanes(lanes)[2]
    t0 = time.perf_counter()
    _key_chain(keys, cycles)
    out = dict(key_chain_s=time.perf_counter() - t0,
               phase12_cycles_per_s=cycles / grids.grids[0].wall_s)
    print(f"[windows] the host draws the key chain of {len(lanes)} lanes x "
          f"{cycles} cycles in {out['key_chain_s']:.3f} s")
    for K in WINDOW_K:

        def windowed():
            ses = sweep.start_lanes(lanes, window=WINDOW)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            snap, windows = None, 0
            while not ses.done():
                ses.advance()
                windows += 1
                if windows == 5:
                    snap = ses.export()
            torch.cuda.synchronize()
            return ses, snap, windows, time.perf_counter() - t0

        with superstep_env(K):
            (ses, snap, windows, run_s), _, dev, _ = counted(windowed)
            one = sweep.run_lanes(lanes)
        got = [dataclasses.asdict(r) for r in ses.finish().results]
        check(got == want and [dataclasses.asdict(r) for r in one.results]
              == want, f"windowed K {K} != the one-shot grid")
        check(one.compile_count == 0, f"one-shot K {K} captured")
        calls = cycles + K * ses.compile_count
        check(dev["grant"]["coop"] == calls,
              f"windowed K {K}: grant launches {dev['grant']} != {calls}")
        out[f"K{K}"] = dict(cycles_per_s=cycles / run_s,
                            one_shot_cycles_per_s=cycles / one.wall_s,
                            captures=ses.compile_count,
                            capture_s=ses.compile_s, windows=windows,
                            launches=dev)
        print(f"[windows] fig11 switchless-1B uniform, {len(lanes)} lanes x "
              f"{cycles} cycles at window {WINDOW}, K {K}: {windows} "
              f"windows, {cycles / run_s:.2f} cycles/s windowed against "
              f"{cycles / one.wall_s:.2f} one-shot on the same graph "
              f"(phase 12's grid: {out['phase12_cycles_per_s']:.2f}, K 1); "
              f"captures {ses.compile_count} ({ses.compile_s:.3f} s); both "
              f"== the phase 12 grid; launches on the card {dev}")
        if K == 1:
            restored, _, dev, _ = counted(lambda: _drain_session(
                sweep.start_lanes(lanes, window=WINDOW, restore=snap)))
            check(restored == want,
                  "export after window 5, restored != one-shot")
            out["launches_restored"] = dev
            print(f"[windows] export after window 5 (cycle "
                  f"{snap['cycle']}) restored into a fresh session == the "
                  f"one-shot grid; launches on the card {dev}")
    return out


def _drain_session(ses):
    while not ses.done():
        ses.advance()
    return [dataclasses.asdict(r) for r in ses.finish().results]


def phase_service(device):
    """A `SimService` on the card with smoke (alice, bob), smoke_faults
    (carol) and smoke_warm_faults (dave): uninterrupted, then killed after
    2 rounds and resumed from its snapshot (the same bytes), then the
    same submissions on the CPU (the same lines after the meta line);
    captures == distinct buckets.  Returns the launches and the
    captures."""
    import shutil
    from repro_torch.core.engine import sweep as SW
    from repro_torch.exp import get_scenario
    from repro_torch.exp.serve import SimService, lower_request
    out_dir = ROOT / "build" / "serve"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    buckets = {u.bucket for rid, (t, s) in enumerate(SERVE_SUBS, start=1)
               for u in lower_request(get_scenario(s), rid, t, 0)[0]}

    def serve(tag, dev, max_rounds=None, resume=False):
        ck = out_dir / f"ck_{tag}"
        path = out_dir / f"{tag}.jsonl"
        if resume:
            svc = SimService.resume(str(ck), out=str(path), device=dev)
        else:
            svc = SimService(out=str(path), window=SERVE_WINDOW,
                             state_dir=str(ck), checkpoint_every=1,
                             device=dev)
            for tenant, name in SERVE_SUBS:
                svc.submit(get_scenario(name), tenant=tenant)
        svc.run(max_rounds=max_rounds)
        svc.close()
        return svc

    SW.clear_aot_cache()
    before = SW.compile_counter()
    base, wall, dev, _ = counted(lambda: serve("base", device))
    captures = SW.compile_counter() - before
    check(base.idle and captures == len(buckets),
          f"serve: {captures} captures for {len(buckets)} buckets")
    killed, _, dev_k, _ = counted(lambda: serve("kr", device, max_rounds=2))
    check(not killed.idle, "serve: the killed run drained")
    resumed, _, dev_r, _ = counted(lambda: serve("kr", device, resume=True))
    check(resumed.idle and SW.compile_counter() - before == captures,
          "serve: the resumed run did not drain or captured")
    check((out_dir / "kr.jsonl").read_bytes()
          == (out_dir / "base.jsonl").read_bytes(),
          "serve: killed + resumed JSONL != uninterrupted")
    serve("cpu", "cpu")
    card, cpu = _jsonl(out_dir / "base.jsonl"), _jsonl(out_dir / "cpu.jsonl")
    check(len(card) == len(cpu) and card[1:] == cpu[1:],
          "serve: CUDA JSONL != CPU JSONL after the meta line")
    results = sum(json.loads(line)["kind"] == "result" for line in card)
    print(f"[serve] {len(SERVE_SUBS)} submissions, {len(buckets)} buckets, "
          f"{captures} captures, {base._round} rounds at window "
          f"{SERVE_WINDOW}, {wall:.2f} s; killed after 2 rounds and resumed "
          f"from its snapshot: the uninterrupted run's {len(card)} lines, "
          f"byte for byte; the CPU's lines after the meta line ({results} "
          f"result records); launches on the card {dev}, killed {dev_k}, "
          f"resumed {dev_r}")
    return {w: {k: dev[w][k] + dev_k[w][k] + dev_r[w][k] for k in dev[w]}
            for w in dev}, captures


# phase 14: what the step pass launches on the card, one a cell
ANALYSIS_ARGS = ("--all", "--lint", "--serve")
ANALYSIS_PASSES = ("spec", "compile", "capacity", "step", "serve", "lint")


# the kernel each step's arbitration runs on the card: (wrapper, kernel)
STEP_KERNEL = {"jnp": ("grant", "coop"), "fused": ("cycle_core", "coop"),
               "compact": ("cycle_core", "three_pass")}
# and the record gathers each step launches a cycle: (wrapper, kernel)
STEP_GATHERS = {"fused": (("head_records", "dense"),
                          ("head_records", "picked"))}
# and the PRNG's draws every step launches a cycle under uniform traffic
# and minimal routing: the cycle key's split, the coins, the destinations
CYCLE_DRAWS = (("threefry", "split"), ("threefry", "uniform"),
               ("threefry", "randint"))


def step_cells_match_cpu(device):
    """Each of the step pass's 27 cells on the card against the CPU (the
    wrappers' plain versions), every state leaf bitwise equal: the pass's
    one-cycle superstep, and the cell's whole warmup + measure run, where
    the arbitration sees contention.  The card's runs must launch the
    step's kernel once a cycle, as the kernels count on the device (these
    are comparison launches, outside the path's counts)."""
    import torch
    from repro_torch.analysis import steppass
    from repro_torch.core.engine import graphs
    from repro_torch.kernels.netsim import ops
    t0 = time.perf_counter()
    hops = []
    for impl in steppass.STEP_IMPLS:
        wrapper, kernel = STEP_KERNEL[impl]
        for vc in steppass.VC_MODES:
            for fk in steppass.FAULT_KINDS:
                for cycles in (1, steppass.CELL_CYCLES):
                    tag = f"step:{impl}/{vc}/{fk} x {cycles} cycle(s)"
                    d0 = ops.device_launches()
                    card = steppass.run_cell(impl, vc, fk, device,
                                             cycles=cycles)
                    torch.cuda.synchronize()
                    d1 = ops.device_launches()
                    cpu = steppass.run_cell(impl, vc, fk, "cpu",
                                            cycles=cycles)
                    ran = {w: {k: d1[w][k] - d0[w][k] for k in d1[w]}
                           for w in d1}
                    once = {(wrapper, kernel), *STEP_GATHERS.get(impl, ()),
                            *CYCLE_DRAWS}
                    want_ran = {w: {k: cycles if (w, k) in once else 0
                                    for k in ran[w]} for w in ran}
                    check(ran == want_ran,
                          f"{tag}: launches on the card {ran} != one of "
                          f"each of {sorted(once)} a cycle")
                    want = graphs._leaves(cpu["out"])
                    got = graphs._leaves(card["out"])
                    check(got.keys() == want.keys(),
                          f"{tag}: state fields on the card {sorted(got)}")
                    for k, v in got.items():
                        check(v.dtype == want[k].dtype
                              and torch.equal(v.cpu(), want[k]),
                              f"{tag}: state leaf {k} on the card != the "
                              f"CPU's")
                    if cycles > 1:
                        hops.append(int(want["stats.hops"].sum()))
    print(f"[analysis] step pass cells on the card == the CPU, every state "
          f"leaf bitwise, at 1 and {steppass.CELL_CYCLES} cycles "
          f"({2 * len(hops)} runs a device, {time.perf_counter() - t0:.2f} "
          f"s); hops a {steppass.CELL_CYCLES}-cycle cell over its "
          f"{steppass.LANES} lanes: {min(hops)}-{max(hops)}")


def phase_analysis(device, fig11_spec, fig11_captures, serve_captures):
    """`repro_torch.analysis.check.main --all --lint --serve` on the card:
    exit 0 with all six passes, each timed; the step pass's netsim
    launches as the kernels count them, one a cell on the kernel
    `kernel_for` names for its step, and its rule ids and locations
    equal to the CPU's; each cell's state out of the card equal to the
    CPU's, bit for bit (`step_cells_match_cpu`); the compile pass's
    captures for phase 12's spec and the serve pass's at phase 13's window
    equal to what those phases captured.  Returns the launches."""
    import re
    from repro_torch.analysis import Report, compilepass, servepass, steppass
    from repro_torch.analysis.check import main as check_main
    from repro_torch.analysis.specpass import load_spec_file
    from repro_torch.kernels.netsim import ops
    out = ROOT / "build" / "analysis" / "report.json"
    rc, wall, dev, host = counted(lambda: check_main(
        list(ANALYSIS_ARGS) + ["--out", str(out)]))
    report = json.loads(out.read_text())
    check(rc == 0 and not report["failed"],
          f"analysis check exited {rc}: {report['counts']}")
    check(report["passes_run"] == list(ANALYSIS_PASSES),
          f"analysis passes run {report['passes_run']}")
    [timing] = [f["message"] for f in report["findings"]
                if f["rule"] == "CHECK_TIME"]
    print(f"[analysis] check {' '.join(ANALYSIS_ARGS)} on {device}: exit "
          f"{rc}, {report['counts']['total']} findings, wall {wall:.2f} s; "
          f"{timing}")
    n = len(steppass.VC_MODES) * len(steppass.FAULT_KINDS)
    want = {"grant": {"coop": n, "three_pass": 0},
            "cycle_core": {"coop": n, "three_pass": n},
            "head_records": {"dense": n, "picked": n},
            "threefry": {"split": 3 * n, "bits": 0, "uniform": 3 * n,
                         "randint": 3 * n, "bernoulli": 0}}
    check(dev == want and host == want,
          f"analysis step pass launches on the card {dev}, host {host} != "
          f"{want}")
    card = [(f["rule"], f["severity"], f["location"])
            for f in report["findings"] if f["pass_name"] == "step"]
    cpu = Report()
    steppass.run_steppass(cpu, device="cpu")
    check(card == [(f.rule, f.severity, f.location) for f in cpu.findings],
          "analysis: the step pass's rule ids on the card != the CPU's")
    for impl in steppass.STEP_IMPLS:
        counts = [int(re.match(r"(\d+) operations", f["message"]).group(1))
                  for f in report["findings"] if f["rule"] == "STEP_TRACE"
                  and f["location"].startswith(f"step:{impl}/")]
        print(f"[analysis] step pass {impl}: operations per superstep on "
              f"the card over its {len(counts)} cells {counts}")
    print(f"[analysis] step pass launches on the card {dev} (== the "
          f"wrappers' host counts); rule ids and locations == the CPU's "
          f"({len(card)} findings)")
    step_cells_match_cpu(device)
    fig11 = Report()
    spec = load_spec_file(fig11_spec, fig11)
    check(spec is not None, f"analysis: {fig11_spec} does not load")
    compilepass.check_spec(spec, f"spec:{fig11_spec}", fig11, device=device)
    [sig] = [f.message for f in fig11.findings if f.rule == "COMPILE_SIG"]
    predicted = int(re.search(r"makes (\d+) graph", sig).group(1))
    check(predicted == fig11_captures,
          f"analysis: compile pass predicts {predicted} captures for "
          f"phase 12's fig11, which made {fig11_captures}")
    serve = Report()
    servepass.check_submission(servepass.SMOKE_SUBMISSION, serve,
                               window=SERVE_WINDOW)
    [bucket] = [f.message for f in serve.findings
                if f.rule == "SERVE_BUCKET"]
    served = int(re.search(r"sessions make (\d+) graph", bucket).group(1))
    check(served == serve_captures,
          f"analysis: serve pass predicts {served} captures, phase 13's "
          f"service made {serve_captures}")
    print(f"[analysis] compile pass on {fig11_spec}: {sig}")
    print(f"[analysis] == phase 12's first run ({fig11_captures} captures); "
          f"serve pass at window {SERVE_WINDOW}: {served} graphs == phase "
          f"13's service captures ({serve_captures})")
    return dev


# phase 15: training on the card.  (a) smoke configs in fp32, card against
# CPU from the same weights: (arch, MoE dispatch)
TRAIN_SMOKE = (("minicpm-2b", "bf16"), ("deepseek-moe-16b", "bf16"),
               ("deepseek-moe-16b", "int8"), ("mamba2-780m", "bf16"),
               ("recurrentgemma-2b", "bf16"))
TRAIN_STEPS, TRAIN_LR = 3, 1e-3
# a parameter element off by more than this after the steps is counted; at
# most TRAIN_OFF_SHARE of a model's may be (see `phase_train_parity`)
TRAIN_ABS, TRAIN_OFF_SHARE = 1e-5, 1e-3
# (c) the launcher's own example at full width
TRAIN_FULL = ("--arch", "minicpm-2b", "--steps", "6", "--batch", "8",
              "--seq", "128", "--lr", "3e-4", "--ckpt-every", "0")
# steps 1-2 against the fp32 plain path, relative: bf16 logits of ~200
# carry rounding steps of 0.5-1, ~1e-3 of the loss; the gradient sums
# bf16 products over 40 layers recomputed under remat
TRAIN_FULL_LOSS, TRAIN_FULL_NORM = 1e-2, 5e-2
# the same run with a tenth of the step (see `phase_train_full`)
TRAIN_FULL_LOW_LR = 3e-5
# phase 16: MoE serving at full width
MOE_SERVE = ("deepseek-moe-16b", 2048)
# phase 17: the vision prefix (576 rows before the prompt) and the
# encoder-decoder (2,048 source frames, the prompt's length, as the serve
# command line draws them) at full width
FRONTEND_SERVE = (("phi-3-vision-4.2b", 2048), ("seamless-m4t-medium", 2048))


def _smoke_train_cfg(arch, dispatch):
    from repro_torch.configs.registry import get_config
    cfg = dataclasses.replace(get_config(arch + "-smoke"), dtype="float32")
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch=dispatch))
    return cfg


def phase_kernels_refuse_autograd(device):
    """Each LM kernel's wrapper raises on CUDA where autograd would record
    the launch (its output has no grad_fn), and runs under no_grad."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rglru import ops as rglru_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    g = torch.Generator(device=device).manual_seed(5)

    def t(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=device).to(dtype)
    calls = {
        "flash_attention": (fa_ops.flash_attention,
                            [t(1, 64, 2, 64, dtype=torch.bfloat16)
                             for _ in range(3)]),
        "ssd_scan": (ssd_ops.ssd_scan,
                     [t(1, 64, 2, 16), t(1, 64, 2).abs(), t(2).abs(),
                      t(1, 64, 16), t(1, 64, 16)]),
        "rglru": (rglru_ops.rglru_scan, [t(1, 64, 32).sigmoid(),
                                         t(1, 64, 32)])}
    for name, (fn, args) in calls.items():
        args[0].requires_grad_()
        try:
            fn(*args)
        except RuntimeError as e:
            check("no backward" in str(e), f"{name}: {e}")
        else:
            raise RuntimeError(f"check failed: {name} launched under "
                               f"autograd")
        with torch.no_grad():
            check(bool(torch.isfinite(fn(*args)).all()),
                  f"{name} under no_grad")
    torch.cuda.synchronize()
    print(f"[train] on CUDA {', '.join(calls)} raise where autograd would "
          f"record them (forward-only kernels) and run under no_grad")


def phase_train_parity(device):
    """15(a): `TRAIN_STEPS` train steps of each `TRAIN_SMOKE` config in
    fp32 (chunked attention, remat, microbatch 2, weight decay 0.1) on the
    card and on the CPU from the same weights and batches.  Metrics at
    1e-5 relative.  Parameters: every element within `TRAIN_ABS` but at
    most `TRAIN_OFF_SHARE` of a model's, and those within Adam's largest
    move over the steps (2 x the sum of the lrs): where a gradient element
    is at the level of rounding noise, below Adam's eps, AdamW divides it
    by itself and the two runs' noise moves the element by up to lr a
    step (the port against the reference on the CPU shows the same, at
    one element of 4,096 in recurrentgemma's first layer).  m and v at
    1e-3 of each leaf's largest value.  Returns the largest differences."""
    import copy
    import torch
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.models import transformer as TF
    from repro_torch.optim.optimizer import OptConfig, init_opt_state
    from repro_torch.runtime.trainer import TrainSetup, make_train_step
    worst = dict(metric=0.0, param=0.0, off=0.0, moment=0.0)
    for arch, dispatch in TRAIN_SMOKE:
        cfg = _smoke_train_cfg(arch, dispatch)
        setup = TrainSetup(model=cfg, opt=OptConfig(
            lr=TRAIN_LR, warmup_steps=1, total_steps=TRAIN_STEPS,
            weight_decay=0.1, schedule=cfg.schedule), attn_impl="chunked",
            remat=True, microbatch=2)
        cpu = TF.init_params(cfg, torch.Generator().manual_seed(2),
                             device="cpu")
        runs = []
        for model in (copy.deepcopy(cpu).to(device), cpu):
            step, opt = make_train_step(setup), init_opt_state(model)
            data = SyntheticTokens(cfg.vocab_size, 4, 64, seed=3)
            hist = []
            for _ in range(TRAIN_STEPS):
                model, opt, m = step(model, opt, next(data))
                hist.append({k: float(v) for k, v in m.items()})
            runs.append((model, opt, hist))
        (card, copt, chist), (cpu, popt, phist) = runs
        metric = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                     for a, b in zip(chist, phist) for k in b)
        check(metric < 1e-5, f"train {cfg.name} {dispatch}: metrics card vs "
                             f"CPU relative {metric}")
        move = 2 * sum(h["lr"] for h in phist)
        total = off = 0
        param = moment = 0.0
        for name, p in cpu.named_parameters():
            d = (dict(card.named_parameters())[name].detach().cpu()
                 - p.detach()).abs()
            total += d.numel()
            off += int((d > TRAIN_ABS).sum())
            param = max(param, float(d.max()))
            for k in ("m", "v"):
                ref = popt[k][name]
                moment = max(moment, float(
                    (copt[k][name].cpu() - ref).abs().max()
                    / ref.abs().max().clamp_min(1e-30)))
        check(off <= TRAIN_OFF_SHARE * total and param <= move,
              f"train {cfg.name} {dispatch}: {off} of {total} parameter "
              f"elements off by > {TRAIN_ABS}, largest {param} (Adam's "
              f"largest move {move})")
        check(moment < 1e-3, f"train {cfg.name} {dispatch}: m, v card vs "
                             f"CPU {moment}")
        print(f"[train] {cfg.name} fp32 dispatch {dispatch}: "
              f"{TRAIN_STEPS} steps card == CPU: metrics relative "
              f"{metric:.3e}; parameters largest {param:.3e}, {off} of "
              f"{total} elements above {TRAIN_ABS}; m, v {moment:.3e}; "
              f"losses {[round(h['loss'], 6) for h in chist]}")
        for k, v in (("metric", metric), ("param", param),
                     ("off", off / total), ("moment", moment)):
            worst[k] = max(worst[k], v)
    return worst


def phase_train_faults(device):
    """15(b): the reference's failure-injection run on the card (bf16
    minicpm-2b smoke, failures at steps 6 and 13, a snapshot every 4
    steps, 20 steps): two restarts logged; then a snapshot at step 20,
    three more steps and its restore, every param (bf16) and optimizer
    leaf bit for bit the saved one."""
    import shutil
    import torch
    from repro_torch.checkpoint.checkpointing import Checkpointer
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.optim.optimizer import OptConfig
    from repro_torch.runtime.fault_tolerance import (FailureInjector,
                                                     FaultTolerantLoop)
    from repro_torch.runtime.trainer import Trainer, TrainSetup
    cfg = get_config("minicpm-2b-smoke")
    setup = TrainSetup(model=cfg, opt=OptConfig(
        lr=2e-3, warmup_steps=2, total_steps=40, schedule="wsd",
        weight_decay=0.0), attn_impl="naive", remat=False)
    ckdir = ROOT / "build" / "train" / "faults"
    shutil.rmtree(ckdir, ignore_errors=True)
    tr = Trainer(setup, SyntheticTokens(cfg.vocab_size, 4, 32, seed=3),
                 checkpointer=Checkpointer(str(ckdir), keep=2),
                 ckpt_every=4, device=device)
    loop = FaultTolerantLoop(tr, FailureInjector(fail_at=(6, 13)))
    hist = loop.run(20)
    events = [e["event"] for e in loop.log]
    check(tr.step == 20 and loop.restarts == 2
          and events.count("failure") == 2 and events.count("restart") == 2,
          f"fault-tolerant loop: step {tr.step}, log {loop.log}")
    check(all(np.isfinite(h["nll"]) for h in hist), "non-finite nll")
    tr.save()
    saved = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    opt = {k: {n: t.clone() for n, t in tr.opt_state[k].items()}
           for k in ("master", "m", "v")}
    tr.run(3)
    check(tr.restore(20) == 20, "restore did not return step 20")

    def bits(t):
        return t.detach().view(torch.int16) if t.dtype == torch.bfloat16 \
            else t.detach()
    same = all(torch.equal(bits(p), bits(saved[n]))
               for n, p in tr.model.named_parameters())
    same &= all(torch.equal(tr.opt_state[k][n], t)
                for k, leaves in opt.items() for n, t in leaves.items())
    check(same, "restored training state != the saved one")
    dtypes = sorted({str(p.dtype) for p in saved.values()})
    print(f"[train] {cfg.name} {cfg.dtype} on the card, failures at steps 6 "
          f"and 13: {loop.restarts} restarts, log {loop.log}; step 20 "
          f"reached, nll {hist[-1]['nll']:.4f}; a snapshot at step 20 "
          f"restored after 3 more steps: every param ({', '.join(dtypes)}) "
          f"and optimizer leaf bit for bit")
    shutil.rmtree(ckdir, ignore_errors=True)


def train_full_reference(cfg, B, S, opt, device):
    """The launcher's first two steps recomputed on the plain path: the
    trainer's weights (`init_params`, seed 0, in the model's dtype) held in
    fp32, the launcher's batches, naive attention, no remat.  Step 1's
    loss, nll and grad_norm; then AdamW's first step in closed form,
    written apart from `adamw_update` (after one step m / (1 - b1) is the
    clipped gradient g and v / (1 - b2) is g^2, so each element moves by
    lr * (g / (|g| + eps) + decay * w)), and step 2's nll on the next
    batch.  Returns {"loss", "nll", "grad_norm", "nll_2"}."""
    import torch
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.models import transformer as TF
    from repro_torch.optim.optimizer import decays
    data = SyntheticTokens(cfg.vocab_size, B, S)

    def batch():
        return {k: torch.as_tensor(v, device=device)
                for k, v in next(data).items()}
    fp32 = dataclasses.replace(cfg, dtype="float32")
    model = TF.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                           device=device).float()
    params = dict(model.named_parameters())
    loss, met = TF.lm_loss(model, fp32, batch(), attn_impl="naive",
                           remat=False)
    grads = torch.autograd.grad(loss, list(params.values()))
    out = {"loss": float(loss.detach()), "nll": float(met["nll"].detach())}
    del loss, met
    with torch.no_grad():
        norm = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads))
        out["grad_norm"] = float(norm)
        scale = min(1.0, opt.clip_norm / max(float(norm), 1e-9))
        for (name, p), g in zip(params.items(), grads):
            g = g * scale
            p -= opt.lr * (g / (g.abs() + opt.eps)
                           + opt.weight_decay * decays(name, p) * p)
        del grads
        _, met = TF.lm_loss(model, fp32, batch(), attn_impl="naive",
                            remat=False)
        out["nll_2"] = float(met["nll"])
    del model, params
    torch.cuda.empty_cache()
    return out


def phase_train_full(device):
    """15(c): minicpm-2b at full width through `launch.train.main`
    (`TRAIN_FULL`: bf16, chunked attention with remat, the WSD schedule at
    lr 3e-4 from step 1): finite losses; steps 1 and 2 held to
    `train_full_reference` on the same weights and batches (step 1's loss
    and nll within TRAIN_FULL_LOSS and its grad_norm within
    TRAIN_FULL_NORM, relative; step 2's nll, after the first update,
    within TRAIN_FULL_LOSS); the last step's nll below the first's.  Step
    time (median of the steps after the first), tokens/s, peak memory;
    then one more step under torch.profiler; then the same run at
    TRAIN_FULL_LOW_LR, whose nll by step is printed beside the first's."""
    import statistics
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch import train as launch_train
    from repro_torch.optim.optimizer import OptConfig
    arg = dict(zip(TRAIN_FULL[::2], TRAIN_FULL[1::2]))
    B, S = int(arg["--batch"]), int(arg["--seq"])
    opt = OptConfig(lr=float(arg["--lr"]))
    ref = train_full_reference(get_config(arg["--arch"]), B, S, opt, device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    argv = list(TRAIN_FULL) + ["--ckpt-dir", str(ROOT / "build" / "train" /
                                                 "full")]
    t0 = time.perf_counter()
    tr = launch_train.main(argv, device=device)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    hist, cfg = tr.history, tr.setup.model
    check(all(np.isfinite(h[k]) for h in hist for k in h),
          f"train {cfg.name}: non-finite metrics {hist}")
    check(hist[0]["lr"] == np.float32(opt.lr),
          f"train {cfg.name}: step 1's lr {hist[0]['lr']}, want {opt.lr}")
    got = dict(hist[0], nll_2=hist[1]["nll"])
    rel = {k: abs(got[k] - v) / abs(v) for k, v in ref.items()}
    for k, r in rel.items():
        bar = TRAIN_FULL_NORM if k == "grad_norm" else TRAIN_FULL_LOSS
        check(r < bar, f"train {cfg.name}: {k} {got[k]} against the fp32 "
                       f"plain path's {ref[k]}: relative {r} >= {bar}")
    check(hist[-1]["nll"] < hist[0]["nll"],
          f"train {cfg.name}: nll {hist[0]['nll']} -> {hist[-1]['nll']}")
    step_s = statistics.median(tr.step_times[1:])
    lrs = ", ".join(f"{h['lr']:.3e}" for h in hist)
    print(f"[train] {cfg.name} steps 1-2 against the fp32 plain path "
          f"(naive attention, no remat, AdamW's first step in closed form) "
          f"on the same weights and batches: "
          + ", ".join(f"{k} {got[k]:.6g} / {v:.6g} ({rel[k]:.3e})"
                      for k, v in ref.items())
          + f"; bars {TRAIN_FULL_LOSS:.0e} (losses), {TRAIN_FULL_NORM:.0e} "
            f"(grad_norm)")
    print(f"[train] {cfg.name} full width ({cfg.num_params()} parameters, "
          f"{cfg.dtype}, chunked attention, remat), batch {B}, seq {S}, "
          f"{len(hist)} steps in {wall:.2f} s (init included): nll "
          f"{[round(h['nll'], 4) for h in hist]}, lr [{lrs}]; step ms "
          f"{[round(t * 1e3, 2) for t in tr.step_times]}, median after the "
          f"first {step_s * 1e3:.2f} ms, {B * S / step_s:.1f} tokens/s; "
          f"max_memory_allocated {peak} bytes")
    nll = [round(h["nll"], 4) for h in hist]
    tr.data = SyntheticTokens(cfg.vocab_size, B, S)
    tr.data.restore({"step": tr.step})
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.run(1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    profile_report(prof, wall, f"{cfg.name} train step (batch {B}, seq {S})",
                   1, "step", ())
    del tr
    torch.cuda.empty_cache()
    low = launch_train.main(argv + ["--lr", str(TRAIN_FULL_LOW_LR)],
                            device=device)
    print(f"[train] {cfg.name} the same run at lr {TRAIN_FULL_LOW_LR}: nll "
          f"{[round(h['nll'], 4) for h in low.history]} (at lr "
          f"{opt.lr}: {nll})")
    del low
    torch.cuda.empty_cache()
    return dict(step_ms=step_s * 1e3, tokens_per_s=B * S / step_s,
                peak=peak, against_fp32=rel)


# phase 18: the sharded step and the dry-run
SHARDED_STEPS = 3
DRYRUN_PEAK_GAP, DRYRUN_FLOPS_GAP = 0.10, 1e-3
DRYRUN_JOBS = 8         # worker processes tracing the cells at once
DRYRUN_CELLS = tuple(
    [("minicpm-2b", shape, multi) for shape in
     ("train_4k", "prefill_32k", "decode_32k", "long_500k")
     for multi in (False, True)]
    + [("deepseek-moe-16b", "train_4k", multi) for multi in (False, True)]
    + [("mamba2-780m", "long_500k", False),
       ("recurrentgemma-2b", "long_500k", False),
       ("phi-3-vision-4.2b", "prefill_32k", False),
       ("seamless-m4t-medium", "prefill_32k", False)])


@contextlib.contextmanager
def nccl_rank(tag):
    """An NCCL process group of one rank over a `FileStore` under
    `build/dist/`; destroyed on exit."""
    import torch
    import torch.distributed as dist
    store = ROOT / "build" / "dist" / f"{tag}.store"
    store.parent.mkdir(parents=True, exist_ok=True)
    if store.exists():
        store.unlink()
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    t = tree.to_local() if isinstance(tree, DTensor) else tree
    return t.numel() * t.element_size()


def _kernels_a_step(tr):
    """One more step of trainer `tr` under torch.profiler: the CUDA
    kernels it launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tr.run(1)
        torch.cuda.synchronize()
    events = prof.key_averages()
    attr = ("self_device_time_total"
            if hasattr(events[0], "self_device_time_total")
            else "self_cuda_time_total")
    return sum(e.count for e in events if getattr(e, attr) > 0
               and e.device_type == torch.autograd.DeviceType.CUDA)


def phase_sharded_step(device):
    """18(a): minicpm-2b at full width, the plain `Trainer` then
    `Trainer(..., mesh=make_host_mesh(model=1))` on an NCCL rank, from the
    same seed and batches (`SHARDED_STEPS` steps); then, on the sharded
    trainer, step 2's peak is its own, one step under `FlopCounterMode`
    and one under torch.profiler (the plain trainer too).  Returns the
    real numbers phase 18(b) predicts."""
    import statistics
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim.optimizer import OptConfig
    from repro_torch.runtime.trainer import Trainer, TrainSetup, full
    arg = dict(zip(TRAIN_FULL[::2], TRAIN_FULL[1::2]))
    B, S = int(arg["--batch"]), int(arg["--seq"])
    cfg = get_config(arg["--arch"])
    setup = TrainSetup(model=cfg, opt=OptConfig(
        lr=float(arg["--lr"]), warmup_steps=1, total_steps=SHARDED_STEPS,
        schedule=cfg.schedule), attn_impl="chunked", remat=True)
    torch.cuda.empty_cache()
    tr = Trainer(setup, SyntheticTokens(cfg.vocab_size, B, S),
                 device=device)
    plain_hist = tr.run(SHARDED_STEPS)
    plain_ms = statistics.median(tr.step_times[1:]) * 1e3
    plain = {n: p.detach().cpu() for n, p in tr.model.named_parameters()}
    plain_kernels = _kernels_a_step(tr)
    del tr
    torch.cuda.empty_cache()
    with nccl_rank("sharded_step"):
        mesh = make_host_mesh(model=1)
        tr = Trainer(setup, SyntheticTokens(cfg.vocab_size, B, S),
                     device=device, mesh=mesh)
        tr.run(1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        tr.run(SHARDED_STEPS - 1)
        peak = torch.cuda.max_memory_allocated()
        hist = tr.history
        metric = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                     for a, b in zip(hist, plain_hist) for k in b)
        param = max(float((full(p).detach().cpu() - plain[n]).abs().max())
                    for n, p in tr.model.named_parameters())
        check(metric < 1e-5 and param < 1e-5,
              f"sharded {cfg.name} on a one-rank mesh against the plain "
              f"step: metrics relative {metric}, parameters {param}")
        sharded_ms = statistics.median(tr.step_times[1:]) * 1e3
        arg_bytes = (_local_bytes(dict(tr.model.named_parameters()))
                     + _local_bytes(tr.opt_state)
                     + 2 * B * S * 4)      # tokens and labels, int32
        with FlopCounterMode(display=False) as fc:
            tr.run(1)
        flops = fc.get_total_flops()
        kernels = _kernels_a_step(tr)
        del tr
        torch.cuda.empty_cache()
        phase_collectives_nccl(device)
    print(f"[sharded] {cfg.name} full width, batch {B} x {S}, "
          f"{SHARDED_STEPS} steps on a (1, 1) NCCL mesh against the plain "
          f"Trainer: metrics relative {metric:.3e}, parameters largest "
          f"{param:.3e}; step ms median plain {plain_ms:.2f}, sharded "
          f"{sharded_ms:.2f} (DTensor's host cost "
          f"{sharded_ms - plain_ms:+.2f} ms); kernels a step plain "
          f"{plain_kernels}, sharded {kernels}; step 2 peak {peak} bytes "
          f"({held} held before it); FLOPs a step {flops}")
    return dict(B=B, S=S, arch=cfg.name, arg_bytes=arg_bytes, peak=peak,
                flops=flops, plain_ms=plain_ms, sharded_ms=sharded_ms,
                kernels=kernels, plain_kernels=plain_kernels)


def phase_collectives_nccl(device):
    """18(d): each collective of `core/collectives.py` and
    `pod_compressed_psum` bound to NCCL at one rank: the n = 1 path,
    whose result is the input (with the int8 round trip for the pod
    sum).  One card holds no second NCCL rank: the cross-rank results are
    held on the CPU only, by 8 gloo ranks
    (`tests/test_torch_collectives.py`)."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core import collectives as C
    from repro_torch.optim.compression import (decompress,
                                               pod_compressed_psum)
    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    x = torch.randn(8, 36, device=device,
                    generator=torch.Generator(device).manual_seed(5))
    outs = {"ring": C.ring_all_reduce(x, mesh, "model"),
            "bidir": C.bidir_ring_all_reduce(x, mesh, "model"),
            "hierarchical": C.hierarchical_psum(x, mesh, "model", "data"),
            "2d": C.psum_2d(x, mesh, "model", "data"),
            "reduce_scatter": C.reduce_scatter(x, mesh, "model"),
            "all_gather": C.all_gather(x, mesh, "data")}
    for name, y in outs.items():
        check(torch.equal(y, x), f"collective {name} at one NCCL rank "
                                 f"is not the identity")
    pod = init_device_mesh("cuda", (1, 1), mesh_dim_names=("pod", "data"))
    err = {"w": torch.zeros_like(x)}
    summed, new_err = pod_compressed_psum({"w": x}, err, mesh=pod)
    q = torch.clamp(torch.round(x / (x.abs().max() / 127.0)), -127, 127)
    check(torch.equal(summed["w"], decompress(q, x.abs().max() / 127.0))
          and torch.equal(new_err["w"], x - summed["w"]),
          "pod_compressed_psum at one NCCL rank")
    torch.cuda.synchronize()
    print(f"[sharded] collectives on NCCL at one rank: {sorted(outs)} and "
          f"pod_compressed_psum == their one-rank results")


def phase_dryrun_predictions(real):
    """18(b): the dry-run of phase 18(a)'s step (same model, batch 8 x
    128, a (1, 1) mesh, `cuda` fake tensors) against the real step."""
    from repro_torch.launch.dryrun import lower_cell
    t0 = time.perf_counter()
    art = lower_cell(real["arch"], "train_4k", False, mesh_shape=(1, 1),
                     device="cuda", batch=real["B"], seq_len=real["S"])
    wall = time.perf_counter() - t0
    mem = art["memory"]
    predicted = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    peak_gap = (predicted - real["peak"]) / real["peak"]
    flops_gap = (art["flops"] - real["flops"]) / real["flops"]
    check(mem["argument_size_in_bytes"] == real["arg_bytes"],
          f"dry-run argument bytes {mem['argument_size_in_bytes']} != the "
          f"real step's {real['arg_bytes']}")
    check(abs(peak_gap) <= DRYRUN_PEAK_GAP,
          f"dry-run peak {predicted} vs the real step's {real['peak']}: "
          f"{peak_gap:+.2%}")
    check(abs(flops_gap) <= DRYRUN_FLOPS_GAP,
          f"dry-run FLOPs {art['flops']} vs FlopCounterMode's "
          f"{real['flops']}: {flops_gap:+.3%}")
    print(f"[dryrun] {real['arch']} batch {real['B']} x {real['S']} on a "
          f"(1, 1) mesh against the real sharded step: argument bytes "
          f"{mem['argument_size_in_bytes']} == {real['arg_bytes']}; "
          f"predicted peak {predicted} vs max_memory_allocated "
          f"{real['peak']} ({peak_gap:+.3%}); FLOPs {art['flops']:.6e} vs "
          f"{real['flops']:.6e} ({flops_gap:+.4%}); traced in {wall:.2f} s")
    return dict(peak_gap=peak_gap, flops_gap=flops_gap)


def phase_dryrun_cells():
    """18(c): `DRYRUN_CELLS` at 256 / 512 ranks on `cuda` fake tensors,
    traced by `DRYRUN_JOBS` worker processes at once (each its own fake
    process group)."""
    from repro_torch.configs.base import shape_by_name
    from repro_torch.configs.registry import cell_applicable, get_config
    from repro_torch.launch.dryrun import run_cells
    out = {}
    t0 = time.perf_counter()
    arts = dict(run_cells(DRYRUN_CELLS, DRYRUN_JOBS, device="cuda"))
    wall = time.perf_counter() - t0
    print(f"[dryrun] {len(DRYRUN_CELLS)} production-mesh cells traced in "
          f"{wall:.1f} s by {DRYRUN_JOBS} processes")
    for arch, shape, multi in DRYRUN_CELLS:
        art = arts[(arch, shape, multi)]
        tag = f"{arch} x {shape} x {'multi' if multi else 'single'}"
        ok, why = cell_applicable(get_config(arch), shape_by_name(shape))
        if not ok:
            check(art["status"] == "skipped" and art["reason"] == why,
                  f"dry-run {tag}: {art}")
            print(f"[dryrun] {tag}: skipped ({why})")
            continue
        check(art["status"] == "ok", f"dry-run {tag}: {art}")
        chips = 512 if multi else 256
        mem, coll = art["memory"], art["collectives"]["by_axis"]
        check(art["chips"] == chips and art["flops"] > 0
              and mem["temp_size_in_bytes"] > 0,
              f"dry-run {tag}: chips {art['chips']}, flops {art['flops']}, "
              f"temp {mem['temp_size_in_bytes']}")
        if multi and art["kind"] == "train":
            check(coll.get("pod", 0) > 0,
                  f"dry-run {tag}: no bytes on pod ({coll})")
        out[tag] = art
        print(f"[dryrun] {tag}: flops {art['flops']:.4e}, argument "
              f"{mem['argument_size_in_bytes']} B, temp "
              f"{mem['temp_size_in_bytes']} B, collectives {coll}, "
              f"{art['collectives']['num_ops']} ops; placed in "
              f"{art['t_lower_s']} s, traced in {art['t_compile_s']} s")
    return out


# phase 19: multi-device placement, logical devices on the one card
PLACEMENT_DEVICES = "2"
# (b) the channel-sharded step runs eagerly (a CUDA graph cannot span
# cards), once in each grant form: phase 4's 300 + 1,200 cycles cut to
# these, on two lanes
SHARDED_CUT = dict(warmup=50, measure=150)
SHARDED_LANES = ((0.4, 0, None), (1.0, 1, None))
PLACEMENT_SUBS = (("alice", "smoke"), ("bob", "smoke_faults"))
# (d) the launcher's example at full width, 3 steps
LAUNCH_MESH = ("--arch", "minicpm-2b", "--steps", "3", "--batch", "8",
               "--seq", "128", "--lr", "3e-4", "--ckpt-every", "0")


@contextlib.contextmanager
def knobs(**values):
    """The environment knobs `values` set inside the block, restored (or
    removed) after it."""
    import os
    old = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _rows_of(results):
    return [dataclasses.asdict(r) for r in results]


def phase_lane_sharding(device, spec, want):
    """19(a): phase 12's first cell (fig11 switch-less 1B uniform, 3 lanes)
    on one sweep, unsharded, then spread over two logical devices on the
    card.  `want` is phase 12's rows of the cell.  Returns the numbers."""
    from repro_torch.core.engine.sweep import BatchedSweep
    from repro_torch.exp import runner
    cell = next(runner.cells(spec))
    cycles = spec.axes.warmup + spec.axes.measure
    lanes = [(r, s, None) for r in spec.axes.rates for s in spec.axes.seeds]
    sweep = BatchedSweep(cell.net, cell.cfg, cell.pattern, device=device)
    one, _, _, _ = counted(lambda: sweep.run_lanes(lanes))
    with knobs(REPRO_HOST_DEVICES=PLACEMENT_DEVICES,
               REPRO_SHARD_MIN_WORK=0):
        run, wall, dev, host = counted(lambda: sweep.run_lanes(lanes))
    check(one.placement == "single" and _rows_of(one.results) == want,
          "placement (a): the unsharded run != phase 12's")
    check(run.placement == "lanes:2" and run.pad_fraction == 0.25,
          f"placement (a): {run.placement}, pad {run.pad_fraction}")
    check(_rows_of(run.results) == want,
          "placement (a): the lanes:2 run != phase 12's, lane for lane")
    calls = 2 * cycles + run.superstep * run.compile_count
    check(run.compile_count == 1 and dev["grant"]["coop"] == calls
          and not any(dev["cycle_core"].values()),
          f"placement (a): {run.compile_count} captures, grant launches "
          f"{dev['grant']} != {calls} (two chunks x cycles + the warm-up)")
    out = dict(cycles_per_s=cycles / run.wall_s,
               single_cycles_per_s=cycles / one.wall_s,
               captures=run.compile_count, capture_s=run.compile_s,
               launches=dev)
    print(f"[placement] (a) {cell.topology.label} {cell.traffic.label}, "
          f"{len(lanes)} lanes x {cycles} cycles on "
          f"REPRO_HOST_DEVICES={PLACEMENT_DEVICES} (one card): "
          f"{run.placement}, pad_fraction {run.pad_fraction}, every lane "
          f"== phase 12's; {run.compile_count} capture for both chunks "
          f"({run.compile_s:.3f} s); {out['cycles_per_s']:.2f} cycles/s "
          f"against {out['single_cycles_per_s']:.2f} unsharded on the same "
          f"sweep; grant launches on the card {dev['grant']}")
    return out


def phase_channel_sharding(device, net):
    """19(b): the fused step on the full-width net, captured and unsharded,
    then channel-sharded over two logical devices (the eager loop),
    `SHARDED_CUT` cycles on `SHARDED_LANES`: in the form `grant_form`
    picks, then with the `two_pass` form forced (the age minimum
    exchanged, the tie re-masked against it, the priority minimum
    exchanged).  Both pick the same winners.  Returns the numbers."""
    import torch
    from repro_torch.core import traffic
    from repro_torch.core.engine.fused import fused_pad
    from repro_torch.core.engine.sweep import lane_mesh
    from repro_torch.core.simulator import SimConfig, Simulator
    from repro_torch.kernels.netsim import ops
    cfg = SimConfig(**SHARDED_CUT, step_impl="fused")
    cycles = cfg.warmup + cfg.measure
    shards = 2
    sim = Simulator(net, cfg, traffic.uniform(net), device=device)
    lanes = list(SHARDED_LANES)
    fresh_peak()
    one, _, _, _ = counted(lambda: sim._batched.run_lanes(lanes))
    single_peak = torch.cuda.max_memory_allocated()
    fresh_peak()
    with knobs(REPRO_HOST_DEVICES=PLACEMENT_DEVICES,
               REPRO_CHANNEL_SHARDS=shards):
        run, wall, dev, host = counted(lambda: sim._batched.run_lanes(lanes))
        peak = torch.cuda.max_memory_allocated()
        step = sim._batched._step_for(lane_mesh(2, device)[0], 2)
        form = step.form
        step.form = "two_pass"
        try:
            run2, _, dev2, _ = counted(
                lambda: sim._batched.run_lanes(lanes))
        finally:
            step.form = form
    check(run.placement == "lanes:1,shards:2" and run.loop == "eager",
          f"placement (b): {run.placement}, loop {run.loop}")
    check(form == run.grant_form,
          f"placement (b): the step ran {form}, grant_form {run.grant_form}")
    for r, name in ((run, form), (run2, "two_pass")):
        check(_rows_of(r.results) == _rows_of(one.results),
              f"placement (b): the channel-sharded run in the {name} form "
              "!= the unsharded fused run")
    # the sharded step's grant is the plain reduction (its minimum exists
    # only after the shards' exchange): no arbitration or gather kernel
    # runs; each shard draws the cycle's bits over all T terminals (the
    # same draws), one threefry launch a draw
    draws = {w: {k: shards * cycles if (w, k) in CYCLE_DRAWS else 0
                 for k in ops.WRAPPER_KERNELS[w]} for w in ops.WRAPPERS}
    check(dev == dev2 == draws,
          f"placement (b): netsim launches {dev}, {dev2} in the sharded "
          f"runs != {draws}")
    ch_pad, term_pad = fused_pad(net, 2)
    out = dict(cycles=cycles, grant_form=run.grant_form,
               pad_fraction=run.pad_fraction, ch_pad=ch_pad,
               term_pad=term_pad, cycles_per_s=cycles / run.wall_s,
               two_pass_cycles_per_s=cycles / run2.wall_s,
               single_cycles_per_s=cycles / one.wall_s, peak=peak,
               single_peak=single_peak, launches=dev)
    print(f"[placement] (b) fused step, {len(lanes)} lanes, cycles cut "
          f"from {FULL_CFG['warmup']} + {FULL_CFG['measure']} to "
          f"{cfg.warmup} + {cfg.measure}, REPRO_CHANNEL_SHARDS=2 on "
          f"{PLACEMENT_DEVICES} logical devices: {run.placement}, loop "
          f"{run.loop}, grant form {run.grant_form} (unsharded "
          f"{one.grant_form}), ghost channels {ch_pad}, terminals "
          f"{term_pad}, pad_fraction {run.pad_fraction}; every counter == "
          f"the unsharded fused run in both forms; "
          f"{out['cycles_per_s']:.2f} cycles/s ({form}), "
          f"{out['two_pass_cycles_per_s']:.2f} (two_pass forced), against "
          f"{out['single_cycles_per_s']:.2f} captured unsharded; "
          f"peak {peak} bytes (unsharded {single_peak}); netsim launches "
          f"{dev}")
    return out


def _two_cell_spec():
    from repro_torch.exp import registry
    smoke = registry.get_scenario("smoke")
    topo = registry.get_scenario("smoke_fused").topologies[0]
    return dataclasses.replace(smoke, name="smoke_two_cells",
                               topologies=(smoke.topologies[0], topo))


def phase_placement_exp(device):
    """19(c): the runner and the service on two logical devices against
    one device, on the card.  Returns the launches of the two-device runs
    ({"exp": ..., "serve": ...})."""
    import io
    from repro_torch.exp import clear_caches, get_scenario, runner
    from repro_torch.exp.serve import SimService
    from repro_torch.exp.serve.packer import Pack
    moved = EXP_TIMINGS + ("placement", "pad_fraction")
    strip = lambda rows: [{k: v for k, v in r.items() if k not in moved}
                          for r in rows]
    two_cell, faults = _two_cell_spec(), get_scenario("smoke_faults")
    one = [runner.run_experiment(sp, device=device)
           for sp in (two_cell, faults)]
    clear_caches()
    with knobs(REPRO_HOST_DEVICES=PLACEMENT_DEVICES):
        rr, _, dev_rr, _ = counted(
            lambda: runner.run_experiment(two_cell, device=device))
        with knobs(REPRO_SHARD_MIN_WORK=0):
            spread, _, dev_sp, _ = counted(
                lambda: runner.run_experiment(faults, device=device))
    check([g.device for g in rr.grids] == ["cuda:0", "cuda:1"]
          and [g.placement for g in rr.grids] == ["single", "single"],
          f"placement (c): cells on {[g.device for g in rr.grids]}")
    check([g.placement for g in spread.grids] == ["lanes:2"],
          f"placement (c): smoke_faults {[g.placement for g in spread.grids]}")
    check(strip(rr.rows()) == strip(one[0].rows())
          and strip(spread.rows()) == strip(one[1].rows()),
          "placement (c): runner rows on two devices != one device")

    def serve():
        out = io.StringIO()
        svc = SimService(out=out, window=SERVE_WINDOW, device=device)
        for tenant, name in PLACEMENT_SUBS:
            svc.submit(get_scenario(name), tenant=tenant)
        svc.run()
        check(svc.idle, "placement (c): the service did not drain")
        return out.getvalue().splitlines()

    lines_one = serve()
    opened, orig = [], Pack.open.__func__

    def record(cls, sid, bucket, units, **kw):
        pk = orig(cls, sid, bucket, units, **kw)
        opened.append((sid, str(pk.device)))
        return pk

    Pack.open = classmethod(record)
    try:
        with knobs(REPRO_HOST_DEVICES=PLACEMENT_DEVICES):
            lines_two, _, dev_sv, _ = counted(serve)
    finally:
        Pack.open = classmethod(orig)
    check({d for _, d in opened} == {"cuda:0", "cuda:1"},
          f"placement (c): service packs on {opened}")
    check(len(lines_two) == len(lines_one) > 1
          and lines_two[1:] == lines_one[1:],
          "placement (c): service JSONL on two devices != one device")
    print(f"[placement] (c) on {PLACEMENT_DEVICES} logical devices: the "
          f"two-cell spec round-robined ({[g.device for g in rr.grids]}, "
          f"{[g.placement for g in rr.grids]}) and smoke_faults spread "
          f"({spread.grids[0].placement}, pad "
          f"{spread.grids[0].pad_fraction}): rows == one device; the "
          f"service's packs on {opened}: its {len(lines_two)} JSONL lines "
          f"== one device's after the meta line; launches on the card: "
          f"runner {dev_rr} + {dev_sp}, service {dev_sv}")
    exp = {w: {k: dev_rr[w][k] + dev_sp[w][k] for k in dev_rr[w]}
           for w in dev_rr}
    return dict(exp=exp, serve=dev_sv)


def phase_launcher_mesh(device):
    """19(d): `launch.train.main` (`LAUNCH_MESH`) with no process group,
    then in an NCCL group of one rank, where it trains on
    `make_host_mesh(model=1)`: metrics at 1e-5 relative and parameters at
    the phase-15 bar; then `--production-mesh` in that group raises."""
    import torch
    from repro_torch.launch import train as launch_train
    from repro_torch.runtime.trainer import full
    argv = list(LAUNCH_MESH) + ["--ckpt-dir",
                                str(ROOT / "build" / "launch_ckpt")]
    torch.cuda.empty_cache()
    tr = launch_train.main(argv, device=device)
    check(tr.mesh is None, "placement (d): the plain launcher built a mesh")
    plain_hist = tr.history
    plain = {n: p.detach().cpu() for n, p in tr.model.named_parameters()}
    plain_ms = float(np.median(tr.step_times[1:])) * 1e3
    del tr
    torch.cuda.empty_cache()
    with nccl_rank("launcher"):
        tr = launch_train.main(argv, device=device)
        check(tr.mesh is not None and tuple(tr.mesh.mesh.shape) == (1, 1),
              "placement (d): the launcher in a group built no host mesh")
        placed = sum(type(p).__name__ == "DTensor"
                     for p in tr.model.parameters())
        metric = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                     for a, b in zip(tr.history, plain_hist) for k in b)
        move = 2 * sum(h["lr"] for h in plain_hist)
        total = off = 0
        param = 0.0
        for n, p in tr.model.named_parameters():
            d = (full(p).detach().cpu().float() - plain[n].float()).abs()
            total += d.numel()
            off += int((d > TRAIN_ABS).sum())
            param = max(param, float(d.max()))
        mesh_ms = float(np.median(tr.step_times[1:])) * 1e3
        del tr
        torch.cuda.empty_cache()
        try:
            launch_train.main(argv + ["--production-mesh"], device=device)
            err = None
        except ValueError as e:
            err = str(e)
    check(placed > 0 and metric < 1e-5
          and off <= TRAIN_OFF_SHARE * total and param <= move,
          f"placement (d): the launcher on a host mesh against one device: "
          f"{placed} DTensor parameters, metrics relative {metric}, "
          f"{off} of {total} parameter elements off by > {TRAIN_ABS}, "
          f"largest {param} (Adam's largest move {move})")
    check(err is not None and "256-rank process group" in err,
          f"placement (d): --production-mesh on one rank: {err}")
    print(f"[placement] (d) launch.train.main minicpm-2b full width, 3 "
          f"steps: in a one-rank NCCL group on make_host_mesh(model=1) "
          f"({placed} DTensor parameters) == the plain launcher: metrics "
          f"relative {metric:.3e}, parameters largest {param:.3e} ({off} of "
          f"{total} above {TRAIN_ABS}); step ms median plain "
          f"{plain_ms:.2f}, on the mesh {mesh_ms:.2f}; --production-mesh "
          f"raised: {err}")
    return dict(metric=metric, param=param, plain_ms=plain_ms,
                mesh_ms=mesh_ms)


# phase 20: the closing slice.  (a) the public batched scan on the fused
# step of the smoke_fused scenario's net, 2 lanes; (b) a smoke trainer's
# snapshot restored onto phase 18's one-rank NCCL mesh; (c) the three
# example drivers, the train driver with a failure after its first
# snapshot
CLOSING_SCAN = dict(warmup=100, measure=200)
CLOSING_RATES = (0.25, 0.75)
CLOSING_TRAIN = ("--steps", "40", "--inject-failure-at", "25",
                 "--ckpt-every", "20")
CLOSING_SERVE = ("--batch", "4", "--prompt-len", "32", "--gen", "16")


def _bits(t):
    """The bytes of a tensor, for bit-for-bit comparisons."""
    import torch
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def phase_closing_scan(device):
    """20(a): `run_scan_batched` on the card against the CPU: every field
    of the final state equal, one `cycle_core` launch a cycle (+ the
    capture's one-cycle warm-up) counted on the card.  Returns the
    device launches."""
    import torch
    from repro_torch import random as jr
    from repro_torch.core.engine import (build_lane, graphs, make_state,
                                         make_step, run_scan_batched)
    from repro_torch.exp import get_scenario, runner
    cell = next(runner.cells(get_scenario("smoke_fused")))
    cfg = dataclasses.replace(cell.cfg, **CLOSING_SCAN)
    cycles = cfg.warmup + cfg.measure

    def scan_on(dev):
        step, consts = make_step(cell.net, cfg, cell.pattern, device=dev)
        state0 = make_state(cell.net, cfg, consts["NV"],
                            (len(CLOSING_RATES),), device=dev)
        keys = torch.stack([jr.PRNGKey(s) for s in
                            range(len(CLOSING_RATES))]).to(dev)
        args = (step, cycles, cfg.warmup, state0,
                torch.tensor(CLOSING_RATES, device=dev), keys,
                build_lane(cell.net, cfg, device=dev), False)
        return lambda: run_scan_batched(*args)

    want = graphs._leaves(scan_on("cpu")())
    state, wall, launches, _ = counted(scan_on(device))
    got = {k: v.cpu() for k, v in graphs._leaves(state).items()}
    diff = [k for k, v in want.items() if not torch.equal(got[k], v)]
    check(not diff, f"closing (a): run_scan_batched card != CPU in {diff}")
    check(int(want["stats.hops"].sum()) > 0,
          "closing (a): no packet moved")
    calls = cycles + 1
    check(launches["cycle_core"]["coop"] == calls
          and not any(launches["grant"].values())
          and launches["cycle_core"]["three_pass"] == 0,
          f"closing (a): cycle_core launches on the card {launches} != "
          f"{calls} (a cycle + the capture's warm-up)")
    print(f"[closing] (a) run_scan_batched, fused step, smoke_fused net "
          f"({cell.net.num_channels} channels), {len(CLOSING_RATES)} lanes x "
          f"{cycles} cycles: {len(want)} state fields card == CPU; "
          f"cycle_core on the card {launches['cycle_core']} ({calls} = a "
          f"cycle + the warm-up); {wall:.3f} s with the capture")
    return launches


def phase_closing_restore(device):
    """20(b): a minicpm-2b smoke trainer's state after 2 steps, saved, then
    restored with the trainer's own specs as `shardings` onto the
    one-rank NCCL mesh of phase 18: every parameter and AdamW leaf a
    DTensor on cuda:0, its bytes the saved tensor's."""
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim.optimizer import OptConfig
    from repro_torch.runtime import sharding as SH
    from repro_torch.runtime.trainer import Trainer, TrainSetup, train_specs
    t0 = time.perf_counter()
    cfg = get_config("minicpm-2b-smoke")
    tr = Trainer(TrainSetup(model=cfg, opt=OptConfig(
        lr=1e-3, warmup_steps=1, total_steps=2, schedule=cfg.schedule),
        attn_impl="naive", remat=False),
        SyntheticTokens(cfg.vocab_size, 4, 32), device=device)
    tr.run(2)
    saved = tr.state()
    ckpt_dir = ROOT / "build" / "closing" / "ckpt"
    ckpt = Checkpointer(str(ckpt_dir), keep=1)
    ckpt.save(tr.step, saved)
    with nccl_rank("closing"):
        mesh = make_host_mesh(model=1, device_type=torch.device(device).type)
        pspecs, ospecs, _ = train_specs(tr.model, mesh)
        shardings = {"params": SH.shardings(pspecs, mesh),
                     "opt": SH.shardings(ospecs, mesh), "data": None}
        back, step = ckpt.restore(tr.state(), shardings=shardings)
        n, bad = 0, []
        for part in ("params", "opt"):
            flat = SH._tree_leaves(saved[part])
            got = dict(SH._tree_leaves(back[part]))
            for path, want in flat:
                t = got[path]
                n += 1
                if not (isinstance(t, DTensor)
                        and t.to_local().device == torch.device("cuda", 0)
                        and t.dtype == want.dtype
                        and torch.equal(_bits(t.to_local()), _bits(want))):
                    bad.append((part, path))
    check(step == tr.step and not bad
          and int(back["data"]["step"]) == int(saved["data"]["step"]),
          f"closing (b): restore onto the NCCL mesh: step {step}, leaves "
          f"not equal DTensors on cuda:0: {bad[:4]}")
    dtypes = sorted({str(t.dtype) for _, t in SH._tree_leaves(saved["opt"])}
                    | {str(t.dtype) for _, t in
                       SH._tree_leaves(saved["params"])})
    print(f"[closing] (b) {cfg.name} trainer state after {step} steps "
          f"({n} tensors, {', '.join(dtypes)}) restored onto a one-rank "
          f"NCCL mesh by shardings: every leaf a DTensor on cuda:0, bit "
          f"for bit the saved one; {time.perf_counter() - t0:.2f} s with "
          f"the 2 steps")


def phase_closing_examples(device):
    """20(c): the three example drivers on the card: the quickstart's rows
    equal the CPU's, its sweep on the grant kernel; the serve driver's
    command line, then its greedy tokens on the same weights (fp32, drawn
    on the CPU) card == CPU; the train driver with a failure after its
    first snapshot, nll falling.  Returns each run's netsim launches."""
    import copy
    import torch
    from examples import torch_quickstart, torch_serve_lm, torch_train_lm
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as TF
    rows, wall, quick, _ = counted(
        lambda: torch_quickstart.main(["--device", device]))
    t0 = time.perf_counter()
    cpu_rows = torch_quickstart.main(["--device", "cpu"])
    cpu_s = time.perf_counter() - t0
    strip = lambda rr: [{k: v for k, v in r.items() if k != "wall_s"}
                        for r in rr]
    cycles = 300 + 900
    check(strip(rows) == strip(cpu_rows),
          "closing (c): torch_quickstart rows card != CPU")
    check(quick["grant"]["coop"] == cycles + 1
          and not any(quick["cycle_core"].values()),
          f"closing (c): the quickstart's launches {quick} != {cycles + 1} "
          f"grant (3 lanes x {cycles} cycles in lockstep + the warm-up)")
    out, _, serve_n, _ = counted(lambda: torch_serve_lm.main(
        list(CLOSING_SERVE) + ["--device", device]))
    check(out.shape == (4, 16), f"closing (c): serve tokens {out.shape}")
    cfg = dataclasses.replace(get_config("minicpm-2b-smoke"),
                              dtype="float32")
    cpu = TF.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = copy.deepcopy(cpu).to(device)
    toks = [torch_serve_lm.serve(m, cfg, 4, 32, 16, d)[0].cpu()
            for m, d in ((card, device), (cpu, "cpu"))]
    check(torch.equal(toks[0], toks[1]),
          "closing (c): torch_serve_lm greedy tokens card != CPU")
    ckpt_dir = ROOT / "build" / "closing" / "train"
    tr, train_s, train_n, _ = counted(lambda: torch_train_lm.main(
        list(CLOSING_TRAIN) + ["--ckpt-dir", str(ckpt_dir), "--device",
                               device]))
    nll = [h["nll"] for h in tr.history]
    first, last = sum(nll[:10]) / 10, sum(nll[-10:]) / 10
    check(tr.step == 40 and last < first,
          f"closing (c): torch_train_lm at step {tr.step}, nll {first} -> "
          f"{last}")
    print(f"[closing] (c) torch_quickstart rows card == CPU ({wall:.2f} s "
          f"on the card, {cpu_s:.2f} s on the CPU), grant on the card "
          f"{quick['grant']}; torch_serve_lm {' '.join(CLOSING_SERVE)} on "
          f"the card, then fp32 greedy tokens card == CPU "
          f"{toks[0][0, :8].tolist()}; torch_train_lm "
          f"{' '.join(CLOSING_TRAIN)}: nll {first:.3f} -> {last:.3f} over "
          f"{len(nll)} steps in {train_s:.2f} s")
    return dict(quickstart=quick, serve=serve_n, train=train_n,
                first_nll=first, last_nll=last)


def phase_closing(device):
    """Phase 20, timed: (a)-(c) above.  Returns the paths' launches."""
    t0 = time.perf_counter()
    scan = phase_closing_scan(device)
    phase_closing_restore(device)
    ex = phase_closing_examples(device)
    took = time.perf_counter() - t0
    print(f"[closing] phase 20: {took:.2f} s")
    return dict(closing_scan=scan, closing_quickstart=ex["quickstart"],
                closing_serve_lm=ex["serve"], closing_train_lm=ex["train"])


def kernel_entry(name, source, replaces, launches, err, t):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t.get("bound_by", "bytes"),
            "library_ms": t.get("library_ms")}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace a short window of each simulator "
                         "step and of serving with torch.profiler")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    device = "cuda"
    # fp32 products in full fp32 on the card (the defaults, stated)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}")
    phase_build()
    phase_prng(device)
    grant_err = phase_grant_random(device)
    net = full_width_net()
    live_err, grant_args, buf_pkts = phase_grant_live(net, device)
    grant_t = phase_grant_timing(grant_args, buf_pkts)
    del grant_args
    cycle_err = phase_cycle_core_random(device)
    cycle_t = {}
    for impl in FAST_STEPS:
        err, (cargs, ckw) = phase_cycle_core_live(net, device, impl)
        cycle_err = max(cycle_err, err)
        cycle_t[impl] = phase_cycle_core_timing(impl, cargs, ckw)
        del cargs, ckw
    head_t = phase_head_records_timing(device)
    threefry_t = phase_threefry_timing(device)
    torch.cuda.empty_cache()
    grant_run, oracle = phase_main_path(net, device)
    grids, cycle_runs = {}, {}
    for impl in FAST_STEPS:
        cycle_runs[impl], grids[impl] = phase_fast_path(
            net, device, impl, cycle_t[impl]["kernel"])
    check_fast_grids(oracle, grids)
    held = main_path_memory(grant_run["memory_before"])
    if args.profile:
        kernels = dict(jnp="coop", **{impl: cycle_t[impl]["kernel"]
                                      for impl in FAST_STEPS})
        check(grant_run["launches_by_kernel"]["coop"] > 0,
              "the oracle step's grant did not run the coop kernel")
        for impl, kernel in kernels.items():
            phase_profile(net, device, impl,
                          1 if kernel == "coop" else 3)
            for K in GRAPH_K:
                phase_profile_graph(net, device, impl, K)
    phase_small_parity(device)
    graph_t = phase_graphs(net, device)
    fa_err, fa_timed = phase_flash_attention(device)
    fa_t = {label: phase_flash_timing(*fa_timed[label])
            for label in FA_TIMED}
    del fa_timed
    ssd_err, ssd_args = phase_ssd_scan(device)
    ssd_t = phase_ssd_timing(ssd_args)
    del ssd_args
    rglru_err, rglru_args = phase_rglru(device)
    rglru_t = phase_rglru_timing(*rglru_args)
    del rglru_args
    torch.cuda.empty_cache()
    served = {arch: phase_serve(device, arch, S, profile=args.profile)
              for arch, S in SERVE}
    for arch, _ in SERVE + FRONTEND_SERVE:
        phase_lm_parity(device, arch)
    torch.cuda.empty_cache()
    exp_t, fig11, fig11_grids = phase_exp(device)
    windows_t = phase_windows(device, fig11, fig11_grids)
    fig11_rows = _rows_of(fig11_grids.grids[0].sweep_result(0).flat())
    del fig11_grids
    serve_launches, serve_captures = phase_service(device)
    analysis_launches = phase_analysis(
        device, exp_t["fig11"]["spec_path"], exp_t["fig11"]["captures"],
        serve_captures)
    torch.cuda.empty_cache()
    phase_kernels_refuse_autograd(device)
    train_err = phase_train_parity(device)
    phase_train_faults(device)
    train_full = phase_train_full(device)
    arch, S = MOE_SERVE
    served[arch] = phase_serve(device, arch, S, profile=args.profile)
    for arch, S in FRONTEND_SERVE:
        served[arch] = phase_serve(device, arch, S, profile=args.profile)
    torch.cuda.empty_cache()
    real = phase_sharded_step(device)
    dryrun_gaps = phase_dryrun_predictions(real)
    dryrun_cells = phase_dryrun_cells()
    torch.cuda.empty_cache()
    placement = dict(lanes=phase_lane_sharding(device, fig11, fig11_rows),
                     channels=phase_channel_sharding(device, net))
    placement.update(phase_placement_exp(device))
    placement["launcher"] = phase_launcher_mesh(device)
    closing = phase_closing(device)
    # the netsim kernels: the coop kernel's numbers, the three-pass
    # kernel's time on the same inputs beside them
    grant_entry = kernel_entry(
        "netsim.grant", "src/repro_torch/kernels/netsim/csrc/grant_coop.cu",
        "src/repro/kernels/netsim/kernel.py:62", grant_run["launches"],
        max(grant_err, live_err), grant_t)
    grant_entry.update(launches_by_kernel=grant_run["launches_by_kernel"],
                       three_pass_ms=grant_t["three_pass_ms"],
                       cycles_per_s=grant_run["cycles_per_s"],
                       run_cycles_per_s=grant_run["run_cycles_per_s"],
                       host_launches_by_kernel=grant_run[
                           "host_launches_by_kernel"],
                       graph_ms=grant_t["graph_ms"], main_path_memory=held,
                       loops=graph_t["jnp"])
    cycle_entry = kernel_entry(
        "netsim.cycle_core",
        "src/repro_torch/kernels/netsim/csrc/cycle_core_coop.cu",
        "src/repro/kernels/netsim/kernel.py:147",
        sum(r["launches"] for r in cycle_runs.values()), cycle_err,
        cycle_t["fused"])
    cycle_entry["launches_by_kernel"] = {
        kernel: sum(r["launches_by_kernel"][kernel]
                    for r in cycle_runs.values())
        for kernel in ("coop", "three_pass")}
    cycle_entry["three_pass_ms"] = cycle_t["fused"]["three_pass_ms"]
    cycle_entry["graph_ms"] = cycle_t["fused"]["graph_ms"]
    cycle_entry["kernel_by_step"] = {impl: cycle_t[impl]["kernel"]
                                     for impl in FAST_STEPS}
    # the fused step's shapes give the headline numbers; both steps' own
    cycle_entry["by_step"] = {impl: dict(cycle_t[impl], **cycle_runs[impl],
                                         loops=graph_t[impl])
                              for impl in FAST_STEPS}
    # the exp, serve and analysis paths' launches (phases 12-14), each
    # counted on the card over its own run, beside the main path's
    paths = dict(exp_fig11=exp_t["fig11"]["launches"],
                 exp_fig11_again=exp_t["fig11"]["second_run_launches"],
                 exp_small=exp_t["small_launches"],
                 **{f"windowed_K{K}": windows_t[f"K{K}"]["launches"]
                    for K in WINDOW_K},
                 windowed_restored=windows_t["launches_restored"],
                 serve=serve_launches, analysis=analysis_launches,
                 placement_lanes=placement["lanes"]["launches"],
                 placement_channels=placement["channels"]["launches"],
                 placement_exp=placement["exp"],
                 placement_serve=placement["serve"], **closing)
    # the fused step's record gathers (the reference's `b_pkt[...]` and
    # `head[bclip]`, XLA gathers): launches of phase 4's fused run (none
    # in the compact run), the dense form's time beside `take`'s
    head_entry = kernel_entry(
        "netsim.head_records",
        "src/repro_torch/kernels/netsim/csrc/head_records.cu",
        "src/repro/core/engine/fused.py:556",
        sum(sum(r["head_records"].values()) for r in cycle_runs.values()),
        0, head_t)
    head_entry["launches_by_kernel"] = {
        form: sum(r["head_records"][form] for r in cycle_runs.values())
        for form in ("dense", "picked")}
    head_entry.update({k: head_t[k] for k in (
        "picked_ms", "picked_take_ms", "picked_bound_ms")})
    # the PRNG's draws (the reference's `jax.random`, fused by XLA; no TPU
    # kernel): launches of phase 4's three steps, the randint form's time
    # beside its plain version's, every form's under `forms`
    main_runs = [grant_run, *cycle_runs.values()]
    threefry_entry = kernel_entry(
        "netsim.threefry", "src/repro_torch/kernels/netsim/csrc/threefry.cu",
        "src/repro/core/engine/inject.py:159 (jax.random; no TPU kernel)",
        sum(sum(r["threefry"].values()) for r in main_runs), 0, threefry_t)
    threefry_entry["launches_by_kernel"] = {
        form: sum(r["threefry"][form] for r in main_runs)
        for form in ("split", "bits", "uniform", "randint", "bernoulli")}
    threefry_entry["forms"] = threefry_t["forms"]
    for entry, wrapper in ((grant_entry, "grant"),
                           (cycle_entry, "cycle_core"),
                           (head_entry, "head_records"),
                           (threefry_entry, "threefry")):
        entry["by_path"] = {"main": dict(
            launches=entry["launches"],
            launches_by_kernel=entry["launches_by_kernel"])}
        entry["by_path"].update({
            path: dict(launches=sum(n[wrapper].values()),
                       launches_by_kernel=n[wrapper])
            for path, n in paths.items()})
    # llama's prefill gives the flash kernel's headline numbers;
    # recurrentgemma's local layers (hd 256, window 2048), deepseek's MHA
    # prefill (phase 16), phi-3-vision's hd 96 prefill over prefix and
    # prompt and seamless's encoder and decoder (phase 17) their own
    fa_entry = kernel_entry(
        "flash_attention",
        "src/repro_torch/kernels/flash_attention/csrc/"
        "flash_attention_wgmma.cu",
        "src/repro/kernels/flash_attention/kernel.py:25",
        sum(n["flash_attention"] for n in served.values()), fa_err,
        fa_t["serving prefill"])
    fa_entry["launches_by_kernel"] = {
        kernel: sum(n["flash_attention_by_kernel"][kernel]
                    for n in served.values())
        for kernel in ("wgmma", "fma")}
    # mamba2-780m's prefill: every launch on the tensor-core kernel; the
    # FMA kernel's time on the same bf16 inputs beside it
    ssd_entry = kernel_entry(
        "ssd_scan", "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_wgmma.cu",
        "src/repro/kernels/ssd_scan/kernel.py:20",
        sum(n["ssd_scan"] for n in served.values()), ssd_err, ssd_t)
    ssd_entry["launches_by_kernel"] = {
        kernel: sum(n["ssd_scan_by_kernel"][kernel] for n in served.values())
        for kernel in ("wgmma", "fma")}
    ssd_entry["fma_ms"] = ssd_t["fma_ms"]
    # recurrentgemma-2b's prefill: every launch on the ring kernel; the
    # direct kernel's time on the same inputs beside it
    rglru_entry = kernel_entry(
        "rglru", "src/repro_torch/kernels/rglru/csrc/rglru_ring.cu",
        "src/repro/kernels/rglru/kernel.py:20",
        sum(n["rglru"] for n in served.values()), rglru_err, rglru_t)
    rglru_entry["launches_by_kernel"] = {
        kernel: sum(n["rglru_by_kernel"][kernel] for n in served.values())
        for kernel in ("ring", "direct")}
    rglru_entry["direct_ms"] = rglru_t["direct_ms"]
    fa_entry["by_path"] = {
        "llama3.2-3b": dict(fa_t["serving prefill"],
                            launches=served["llama3.2-3b"]["flash_attention"]),
        "recurrentgemma-2b": dict(
            fa_t["recurrentgemma prefill"],
            launches=served["recurrentgemma-2b"]["flash_attention"]),
        "deepseek-moe-16b": dict(
            fa_t["deepseek prefill"],
            launches=served["deepseek-moe-16b"]["flash_attention"]),
        "phi-3-vision-4.2b": dict(
            fa_t["phi-3-vision prefill"],
            launches=served["phi-3-vision-4.2b"]["flash_attention"]),
        "seamless-m4t-medium": dict(
            encoder=fa_t["seamless encoder"],
            decoder=fa_t["seamless decoder"],
            launches=served["seamless-m4t-medium"]["flash_attention"])}
    print(f"[train] summary: smoke card vs CPU {train_err}; minicpm-2b "
          f"full width {train_full}")
    print(f"[dryrun] summary: sharded step {real}; predictions "
          f"{dryrun_gaps}; {len(dryrun_cells)} production-mesh cells ok")
    print(f"[placement] summary: " + json.dumps(
        {k: {n: v for n, v in d.items() if n != "launches"}
         if "launches" in d else d for k, d in placement.items()
         if k in ("lanes", "channels", "launcher")}))
    print(json.dumps({"kernels": [
        grant_entry,
        cycle_entry,
        head_entry,
        threefry_entry,
        fa_entry,
        ssd_entry,
        rglru_entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
