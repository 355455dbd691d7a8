"""Gradient compression with error feedback for the scarce cross-pod tier
(port of `repro.optim.compression`).

The switch-less Dragonfly's global (inter-W-group) links are the lowest
bandwidth tier (Sec. III: off-wafer << on-wafer); when gradients must
cross pods they are quantized to int8 with a per-tensor scale and the
quantization error is carried into the next step (EF-SGD style), which
keeps convergence while cutting cross-pod bytes 4x vs fp32 / 2x vs bf16.

A tree here is a dict of name -> tensor (the port's parameter naming).
"""
from __future__ import annotations

import torch


def init_error_state(params: dict) -> dict:
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}


def compress(x):
    """fp -> (int8, fp32 scale).  Symmetric per-tensor quantization;
    `torch.round` rounds half to even, as `jnp.round`."""
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress(q, scale):
    return q.float() * scale


def ef_compress_tree(grads: dict, err: dict):
    """Apply error feedback then quantize every leaf.

    Returns (tree of (q, scale), new error tree)."""
    qt, new_err = {}, {}
    for name, g in grads.items():
        corrected = g.float() + err[name]
        q, s = compress(corrected)
        qt[name] = (q, s)
        new_err[name] = corrected - decompress(q, s)
    return qt, new_err


def decompress_tree(qt: dict) -> dict:
    return {name: decompress(*t) for name, t in qt.items()}


def pod_compressed_psum(grads, err, pod_axis: str = "pod"):
    """The reference's int8 + error-feedback all-reduce across pods needs
    `psum` / `pmax` over a pod axis, which the port does not have yet."""
    raise NotImplementedError(
        "pod_compressed_psum needs the cross-pod collectives of "
        "core/collectives.py, not ported yet (ROADMAP queue 1 item 6)")
