#!/usr/bin/env python3
"""Where the tensor-core SSD scan kernel spends its time, on one NVIDIA GPU.

    python3 tools/ssd_phases.py     # from the repository root

Builds `src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_wgmma.cu` with a
clock64() read at each phase boundary of its chunk loop (the `PHASES`
below, found by their exact text), runs it at the mamba2-780m prefill
shape (B 4, S 2,048, H 48, P 64, N 128, bf16) and at B 1 (one block an
SM), and prints, for thread 0 of block (0, 0) in its last call, the SM
cycles a chunk spent from each boundary to the next: the chain of
dependent steps one (batch, head)'s walk takes, chunk after chunk.  The
reads cost a few cycles each, so the instrumented kernel runs a little
slower than the kernel; its time is printed beside the kernel's.  The
variant is built from an edited copy under ``build/ssd_phases/``; the
repository's sources are not touched.  Exits nonzero without a CUDA
device.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SHAPES = ((4, 2048, 48, 64, 128), (1, 2048, 48, 64, 128))
# (phase that ends at the mark, "after"/"before" the text, the text)
PHASES = (
    ("wait for the chunk", "after",
     "    __syncthreads();  // chunk c has landed; every warp is done with "
     "c - 1\n"),
    ("scan", "before", "    // -- 2. C B^T (M = i, N = j) and y^T"),
    ("C B^T and y^T = S_in C^T", "before",
     "    // -- 3. the state, S = exp(cum_L) S"),
    ("v and the state update's issue", "before",
     "      // W_ij for this warp's rows"),
    ("W", "before", "      fence_proxy_async();\n#pragma unroll"),
    ("y^T scale", "before", "      __syncthreads();  // W is complete"),
    ("barrier (W complete)", "after",
     "      __syncthreads();  // W is complete\n"),
    ("W x and the wait for the products", "before",
     "    // y [b, t0 + i, h, p]: y^T in bf16"),
    ("store y", "before",
     "    if (tid < kL) dt_slot(st ^ 1)[tid] = dt_next;\n  }"),
)
_PROLOGUE = (
    "__device__ unsigned long long ssd_phase_cycles[16];\n"
    "#define SSD_PHASE(k) if (phase_on) { const unsigned long long now = "
    "clock64(); phase_acc[k] += now - phase_t; phase_t = now; }\n")
_START = ("  const bool phase_on = tid == 0 && blockIdx.x == 0 && "
          "blockIdx.y == 0;\n  unsigned long long phase_t = clock64();\n"
          "  unsigned long long phase_acc[16] = {};\n")
_END = ("  if (phase_on) {\n#pragma unroll\n    for (int k = 0; k < 16; ++k) "
        "ssd_phase_cycles[k] = phase_acc[k];\n  }\n")
_READ = ('\nextern "C" int ssd_phase_read(unsigned long long* out) {\n'
         "  return static_cast<int>(cudaMemcpyFromSymbol(\n"
         "      out, ssd_phase_cycles, sizeof(ssd_phase_cycles)));\n}\n")
# where the prologue, the counters' start and their store go
ANCHORS = ("namespace {\n", "  const int nc = (S + kL - 1) / kL;\n",
           "  // the final state [B, H, P, N]; rows past P")


def instrumented(source: str) -> str:
    """The kernel's source with the phase marks; raises when a mark's
    text is not in it exactly once."""
    for text in ANCHORS + tuple(t for _, _, t in PHASES):
        if source.count(text) != 1:
            raise RuntimeError(f"ssd_phases: {text!r} is not in the "
                               f"kernel's source once")
    out = source.replace(ANCHORS[0], _PROLOGUE + ANCHORS[0])
    out = out.replace(ANCHORS[1], _START + ANCHORS[1])
    for k, (_, where, text) in enumerate(PHASES):
        mark = f"    SSD_PHASE({k})\n"
        out = out.replace(text, text + mark if where == "after"
                          else mark + text)
    return out.replace(ANCHORS[2], _END + ANCHORS[2]) + _READ


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
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd_scan import ops
    if not torch.cuda.is_available():
        print("ssd_phases: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {card}")
    out_dir = build.BUILD_DIR.parent / "ssd_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "ssd_scan_wgmma.cu"
    path.write_text(instrumented(ops.SOURCES[1].read_text()))
    # the variant's library holds the FMA kernel's source too, so that
    # `ops.library` binds it as it is
    lib = ops.library("ssd_phases", [ops.SOURCES[0], path])
    lib.ssd_phase_read.argtypes = [ctypes.c_void_p]
    lib.ssd_phase_read.restype = ctypes.c_int
    rows = []
    for B, S, H, P, N in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(0)
        x = (torch.randn((B, S, H, P), generator=g, device="cuda")
             * 0.5).bfloat16()
        dt = F.softplus(torch.randn((B, S, H), generator=g, device="cuda"))
        A = torch.randn((H,), generator=g, device="cuda").abs() + 0.1
        Bm, Cm = ((torch.randn((B, S, N), generator=g, device="cuda")
                   * 0.3).bfloat16() for _ in range(2))
        y = torch.empty_like(x)
        state = torch.empty((B, H, P, N), device="cuda")

        def run(fn):
            rc = fn(x.data_ptr(), *x.stride()[:3], dt.data_ptr(),
                    A.data_ptr(), Bm.data_ptr(), *Bm.stride()[:2],
                    Cm.data_ptr(), *Cm.stride()[:2], y.data_ptr(),
                    state.data_ptr(), B, S, H, P, N,
                    torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"launch failed: error {rc}")
        kernel_ms = cuda_ms(lambda: run(ops.library().ssd_scan_wgmma_fwd), 20)
        variant_ms = cuda_ms(lambda: run(lib.ssd_scan_wgmma_fwd), 20)
        cycles = (ctypes.c_ulonglong * 16)()
        if lib.ssd_phase_read(ctypes.addressof(cycles)) != 0:
            raise RuntimeError("ssd_phases: reading the counters failed")
        chunks = (S + 63) // 64
        per_chunk = {name: cycles[k] / chunks
                     for k, (name, _, _) in enumerate(PHASES)}
        total = sum(per_chunk.values())
        print(f"[ssd_phases] B={B} S={S} H={H} P={P} N={N}: kernel "
              f"{kernel_ms:.4f} ms, instrumented {variant_ms:.4f} ms; SM "
              f"cycles a chunk, thread 0 of block (0, 0): {total:.0f}")
        for name, c in per_chunk.items():
            print(f"[ssd_phases]   {name}: {c:.0f} ({100 * c / total:.1f}%)")
        rows.append(dict(shape=[B, S, H, P, N], kernel_ms=kernel_ms,
                         instrumented_ms=variant_ms,
                         cycles_per_chunk=per_chunk))
    print(json.dumps({"card": card, "phases": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
