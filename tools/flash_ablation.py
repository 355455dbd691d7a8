#!/usr/bin/env python3
"""Where the tensor-core flash-attention kernel spends its time, on one
NVIDIA GPU.

    python3 tools/flash_ablation.py     # from the repository root

Builds `src/repro_torch/kernels/flash_attention/csrc/flash_attention_wgmma.cu`
as it is and in variants that each drop one step of the online softmax
(the exponentials, the row max, the rescale of O, the packing of P to
bf16, or the whole softmax), and times each at the two served prefill
shapes (llama3.2-3b and recurrentgemma-2b, bf16) beside SDPA.  A variant
computes a wrong result: only its time means anything, and the gap
between the kernel and the variant bounds what that step costs on the
kernel's critical path.  Variants are built from edited copies of the
source under ``build/ablation/``; the repository's sources are not
touched.  Exits nonzero without a CUDA device.
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

H100_BF16_OPS_PER_S = 989.4e12  # dense bf16 tensor cores (NVIDIA data sheet)
# (label, (B, S, H, KV, hd), window) of the served prefills
SHAPES = (("llama3.2-3b", (4, 2048, 24, 8, 128), None),
          ("recurrentgemma-2b", (4, 4096, 10, 1, 256), 2048))
# variant -> (text of the kernel's source, its replacement)
VARIANTS = {
    "no exp": (
        "sc[j] = fast_exp2(fmaf(sc[j], scale_log2, -m_new[(j / 2) % 2]));",
        "sc[j] = fmaf(sc[j], scale_log2, -m_new[(j / 2) % 2]);"),
    "no row max": (
        "      m_new[r] =\n"
        "          fmaxf(st.m[r], quad_max(row_max<BN>(sc, r)) * scale_log2);",
        "      m_new[r] = st.m[r] < -1.f ? 0.f : st.m[r];"),
    "no O rescale": (
        "#pragma unroll\n"
        "          for (int j = 0; j < HD / 2; ++j) "
        "acc[j] *= corr[(j / 2) % 2];\n"
        "          wgmma_fence();",
        "          wgmma_fence();"),
    "no P pack": (
        "          release(v_empty, kt - 1);\n"
        "          pack_p<kBN>(sc, pa);",
        "          release(v_empty, kt - 1);"),
    "no softmax": (
        "        online_softmax<kBN>(sc, st, corr, edge, k0, row0, col0, Sk, "
        "causal,\n"
        "                            has_window, window, scale_log2);",
        "        corr[0] = corr[1] = 1.f;"),
}


def variant_sources(source: str) -> dict:
    """Each variant's text of the kernel's source `source`; raises when a
    variant's text is not in it exactly once."""
    out = {}
    for name, (old, new) in VARIANTS.items():
        if source.count(old) != 1:
            raise RuntimeError(f"variant {name!r}: its text is not in the "
                               f"kernel's source once")
        out[name] = source.replace(old, new)
    return out


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


def launcher(lib):
    """A call of the library's tensor-core entry point."""
    import torch
    fn = lib.flash_attention_wgmma_fwd

    def run(q, k, v, window):
        B, S, H, hd = q.shape
        o = torch.empty_like(q)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S,
                S, H, k.shape[2], hd, 1.0 / math.sqrt(hd), 1,
                int(window is not None), window or 0,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: error {rc}")
        return o
    return run


def main():
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops
    if not torch.cuda.is_available():
        print("flash_ablation: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {card}")
    out_dir = build.BUILD_DIR.parent / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, text in variant_sources(ops.SOURCES[1].read_text()).items():
        paths[name] = out_dir / f"{name.replace(' ', '_')}.cu"
        paths[name].write_text(text)
    # one nvcc a library, all started together; a variant's library holds
    # the FMA kernel's source too, so that `ops.library` binds it as it is
    with ThreadPoolExecutor(len(paths) + 1) as pool:
        jobs = {"kernel": pool.submit(ops.library)}
        jobs.update((name, pool.submit(ops.library,
                                       "flash_ablation_" + path.stem,
                                       [ops.SOURCES[0], path]))
                    for name, path in paths.items())
        runs = {name: launcher(job.result()) for name, job in jobs.items()}
    rows = []
    for label, (B, S, H, KV, hd), window in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn(s, generator=g, device="cuda").bfloat16()
                   for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
        pairs = (S * (S + 1) // 2 if window is None else
                 window * (window + 1) // 2 + (S - window) * window)
        bound_ms = 4 * hd * B * H * pairs / H100_BF16_OPS_PER_S * 1e3
        times = {name: cuda_ms(lambda: run(q, k, v, window), 20)
                 for name, run in runs.items()}
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        if window is None:
            times["SDPA"] = cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), 20)
        else:
            pos = torch.arange(S, device="cuda")
            mask = (pos[None, :] <= pos[:, None]) \
                & (pos[None, :] > pos[:, None] - window)
            times["SDPA"] = cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True), 20)
        for name, ms in times.items():
            print(f"[ablation] {label} {name}: {ms:.4f} ms "
                  f"({bound_ms / ms:.3f} of the {bound_ms * 1e3:.2f} us "
                  f"bound)")
        rows.append(dict(shape=label, bound_ms=bound_ms, ms=times))
    print(json.dumps({"card": card, "ablation": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
