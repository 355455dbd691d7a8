#!/usr/bin/env python3
"""What holds the RG-LRU ring kernel, on one NVIDIA GPU.

    python3 tools/rglru_phases.py     # from the repository root

At the recurrentgemma-2b prefill shape (B 4, S 4,096, R 2,560, fp32) it
times, on the same inputs:

- the ring kernel (`src/repro_torch/kernels/rglru/csrc/rglru_ring.cu`) as
  it is, and built over a grid of its stage depth K (`kStages`) and stage
  length T (`kSteps`), each variant held bit for bit to the direct kernel;
- the same kernel with its copies taken out ("chain and stores"), which
  runs the chain on whatever the ring holds and writes h: the time the
  chain and the stores alone take, without the memory's reads;
- the direct kernel (`csrc/rglru.cu`);
- `torch.add(a, b, out=h)`, a plain streaming kernel that moves the same
  bytes (a and b read once, h written once): what the card reaches on
  this traffic, a yardstick and nothing the port calls.

Each is timed over 100 launches, twice: all of them in order, then in the
reverse order, so that a drift of the card's clocks over the run shows as
a difference between the two.  For each it prints the mean ms a launch
of the two, the achieved GB/s over the function's 503 MB and its share
of the 150.24 us bound, and both passes' ms; for each ring variant also
the blocks resident on an SM and the bytes its copies keep in flight an
SM by design, (K - 1) stages x T steps x 32 channels x 8 bytes x the
blocks an SM.  The variants are built from edited copies under
``build/rglru_phases/`` (one nvcc each, started together); the
repository's sources are not touched.  The last line is JSON.  Exits
nonzero without a CUDA device.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SHAPE = (4, 4096, 2560)
STAGES = (2, 3, 4, 5, 6, 8)        # K
STEPS = (8, 16, 32, 64)            # T
REPS = 100                         # launches a timing
PASSES = 2                         # timings of each, in turns (see main)
H100_BYTES_PER_S = 3.35e12
H100_SMS = 132
SMEM_PER_SM = 233_472              # bytes a block may use on an SM, all told
SMEM_RESERVED = 1_024              # bytes the runtime keeps a block
LANES = 32                         # channels a block (kLanes)
# the source's text for each knob, with the value in the build as {}
KNOBS = {"T": "constexpr int kSteps = {};", "K": "constexpr int kStages = {};"}
# the copies of a stage, taken out for the "chain and stores" variant
COPIES = "  if (s < n) {\n    float* sa = ring"
NO_COPIES = "  if (false && s < n) {\n    float* sa = ring"


def knob(source: str, name: str) -> int:
    """The value the source sets for `name` ("T" or "K"); raises unless
    the knob's line is there once."""
    head = KNOBS[name].split("{}")[0]
    lines = [ln for ln in source.splitlines() if ln.startswith(head)]
    if len(lines) != 1:
        raise RuntimeError(f"rglru_phases: {head!r} is not in the kernel's "
                           f"source once")
    return int(lines[0][len(head):].split(";")[0])


def variant(source: str, T: int | None = None, K: int | None = None,
            copies: bool = True) -> str:
    """The ring kernel's source with T and K set and, without `copies`,
    its copies taken out; raises when an edited text is not in it once."""
    out = source
    for name, value in (("T", T), ("K", K)):
        if value is not None:
            old = KNOBS[name].format(knob(source, name))
            out = out.replace(old, KNOBS[name].format(value))
    if not copies:
        if source.count(COPIES) != 1:
            raise RuntimeError("rglru_phases: the stage's copies are not in "
                               "the kernel's source once")
        out = out.replace(COPIES, NO_COPIES)
    return out


def in_flight(T: int, K: int, B: int, R: int) -> tuple[int, float]:
    """(blocks resident an SM, bytes in flight an SM by design) of the
    ring kernel at (T, K) on a grid of ceil(R / 32) x B blocks."""
    smem = K * 2 * T * LANES * 4
    blocks = math.ceil(R / LANES) * B
    resident = min(32, SMEM_PER_SM // (smem + SMEM_RESERVED),
                   math.ceil(blocks / H100_SMS))
    per_sm = min(resident, blocks / H100_SMS)
    return resident, (K - 1) * T * LANES * 8 * per_sm


def cuda_ms(fn, reps):
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


def main():
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.rglru import ops
    if not torch.cuda.is_available():
        print("rglru_phases: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {card}")
    source = ops.SOURCES[1].read_text()
    T0, K0 = knob(source, "T"), knob(source, "K")
    out_dir = build.BUILD_DIR.parent / "rglru_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    # name -> (T, K, copies); each library holds the direct kernel's
    # source too, so that `ops.library` binds it as it is
    variants = {f"rglru_T{T}_K{K}": (T, K, True)
                for T in STEPS for K in STAGES}
    variants["rglru_chain_only"] = (T0, K0, False)
    paths = {}
    for name, (T, K, copies) in variants.items():
        paths[name] = out_dir / f"{name}.cu"
        paths[name].write_text(variant(source, T, K, copies))
    with ThreadPoolExecutor() as pool:
        libs = dict(zip(variants, pool.map(
            lambda name: ops.library(name, [ops.SOURCES[0], paths[name]]),
            variants)))

    B, S, R = SHAPE
    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.sigmoid(torch.randn(SHAPE, generator=g, device="cuda")) \
        * 0.2 + 0.79
    b = torch.randn(SHAPE, generator=g, device="cuda") * 0.1
    h = torch.empty_like(a)
    nbytes = 3 * a.numel() * 4
    bound_ms = nbytes / H100_BYTES_PER_S * 1e3
    stream = torch.cuda.current_stream().cuda_stream

    def launch(fn):
        rc = fn(a.data_ptr(), b.data_ptr(), h.data_ptr(), B, S, R, stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")

    want = ops.rglru_scan(a, b, kernel="direct")
    # label -> (the function to time, extra fields); the variants' own
    # results are held to the direct kernel's first
    runs = {"direct kernel": (
                lambda: ops.rglru_scan(a, b, kernel="direct"), {}),
            "ring kernel": (lambda: ops.rglru_scan(a, b), dict(T=T0, K=K0)),
            "torch.add(a, b, out=h), the same bytes": (
                lambda: torch.add(a, b, out=h), {})}
    for name, (T, K, copies) in variants.items():
        fn = libs[name].rglru_scan_ring_fwd
        if copies:
            launch(fn)
            torch.cuda.synchronize()
            if not torch.equal(h, want):
                raise RuntimeError(f"rglru_phases: {name} != the direct "
                                   f"kernel")
            resident, flight = in_flight(T, K, B, R)
            runs[f"ring T {T} K {K}"] = (
                lambda fn=fn: launch(fn),
                dict(T=T, K=K, resident=resident,
                     in_flight_bytes_an_sm=round(flight)))
        else:
            runs[f"chain and stores, no copies (T {T}, K {K})"] = (
                lambda fn=fn: launch(fn), dict(T=T, K=K))
    passes = {label: [] for label in runs}
    for p in range(PASSES):
        for label in (list(runs) if p % 2 == 0 else reversed(list(runs))):
            passes[label].append(cuda_ms(runs[label][0], REPS))

    print(f"[rglru_phases] B={B} S={S} R={R} fp32: {nbytes} bytes, bound "
          f"{bound_ms * 1e3:.2f} us at 3.35 TB/s; the source's T {T0}, "
          f"K {K0}")
    rows = []
    for label, (_, extra) in runs.items():
        ms = sum(passes[label]) / PASSES
        row = dict(label=label, ms=ms, passes_ms=passes[label],
                   gb_per_s=nbytes / ms / 1e6, bound_share=bound_ms / ms,
                   **extra)
        rows.append(row)
        more = "".join(f", {k} {v}" for k, v in extra.items())
        each = " / ".join(f"{x:.4f}" for x in passes[label])
        print(f"[rglru_phases] {label}: {ms:.4f} ms ({each}), "
              f"{row['gb_per_s']:.1f} GB/s, {row['bound_share']:.3f} of the "
              f"bound{more}")
    print(json.dumps({"card": card, "shape": list(SHAPE), "bytes": nbytes,
                      "bound_ms": bound_ms, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
