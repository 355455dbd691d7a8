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


def pod_compressed_psum(grads: dict, err: dict, pod_axis: str = "pod", *,
                        mesh):
    """Full-precision reduction within the pod is the data axis' (DTensor's
    gradients); across pods, int8 + error feedback: every rank of the
    `mesh` (a `DeviceMesh` with a `pod_axis` dim) calls this with its own
    grads and error state.  Each leaf's int8 values are summed in int32
    over the pod group and rescaled by the largest scale over it (the
    conservative choice).  Returns (name -> summed fp32 tensor, new error
    tree).  Raises when no process group is initialised."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError(
            "pod_compressed_psum reduces over the mesh's pod axis and needs "
            "an initialised torch.distributed process group")
    from ..core.collectives import all_reduce
    qt, new_err = ef_compress_tree(grads, err)
    summed = {}
    for name, (q, s) in qt.items():
        qs = all_reduce(q.to(torch.int32), mesh, pod_axis, "sum")
        ss = all_reduce(s, mesh, pod_axis, "max")
        summed[name] = qs.to(torch.float32) * ss
    return summed, new_err
