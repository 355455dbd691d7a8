"""Entry point of the flash-attention kernel (port of
`repro.kernels.flash_attention.ops`).

`flash_attention` dispatches on the device of its tensors: CPU tensors go
to the plain version `ref.attention_ref`; CUDA tensors launch one of two
hand-written kernels or raise — there is no fallback.  Which kernel is a
static rule on (dtype, head_dim), `kernel_for`: bf16 at head_dim 64, 128
or 256 runs the tensor-core kernel in ``csrc/flash_attention_wgmma.cu``
(wgmma, TMA-fed, warp-specialised); fp32, and bf16 at 16 or 80, the FMA
kernel in ``csrc/flash_attention.cu``.  Both replace the TPU kernel
`flash_attention_pallas` of `repro.kernels.flash_attention.kernel`.
A head_dim up to 256 that the chosen kernel is not built for (96 for
phi-3-vision) is zero-padded to that kernel's next head_dim, with the
true 1/sqrt(head_dim) as the scale, and the output sliced back: zero
columns add nothing to q.k and give zero output columns, so this is
exact.  The sequence lengths are never padded: the kernels mask on the
true ones.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from .. import refuse_autograd
from ..build import load_library
from .ref import attention_ref

LIBRARY = "flash_attention"
SOURCES = [Path(__file__).parent / "csrc" / name
           for name in ("flash_attention.cu", "flash_attention_wgmma.cu")]
# the head dims each kernel is instantiated for
HEAD_DIMS = (16, 64, 80, 128, 256)      # csrc/flash_attention.cu, fp32/bf16
WGMMA_HEAD_DIMS = (64, 128, 256)        # csrc/flash_attention_wgmma.cu, bf16
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "flash_attention_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
                            _I, _I, _I, _P],
    "flash_attention_wgmma_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                  _F, _I, _I, _I, _P]}


def library(name: str = LIBRARY, sources=SOURCES) -> ctypes.CDLL:
    """The built and loaded kernel library (built at first use).  Another
    `name` with edited `sources` loads a variant of it beside it, as
    ``tools/flash_ablation.py`` does."""
    lib = load_library(name, sources)
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def kernel_for(dtype, head_dim) -> str:
    """The kernel a CUDA call at (dtype, head_dim) launches: "fma" for
    fp32, and for bf16 at the head dims of `HEAD_DIMS` outside
    `WGMMA_HEAD_DIMS` (16, 80); "wgmma" for every other bf16 head dim.
    Head dims up to `MAX_HEAD_DIM` only; raises on anything else."""
    if dtype not in _DTYPES:
        raise ValueError(f"flash_attention: q, k, v must all be float32 or "
                         f"all bfloat16, got {dtype}")
    if not 1 <= head_dim <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {head_dim} not in "
                         f"1..{MAX_HEAD_DIM}")
    if dtype == torch.bfloat16 and head_dim not in (
            set(HEAD_DIMS) - set(WGMMA_HEAD_DIMS)):
        return "wgmma"
    return "fma"


def kernel_head_dim(kernel, head_dim) -> int:
    """The head dim `kernel` runs `head_dim` at: itself if the kernel is
    built for it, else the next one it is built for (zero padding)."""
    dims = WGMMA_HEAD_DIMS if kernel == "wgmma" else HEAD_DIMS
    return min(d for d in dims if d >= head_dim)


def padded_operands(q, k, v, kernel):
    """q, k, v zero-padded in the head dim to `kernel_head_dim` (unchanged
    when the kernel takes it); the caller passes the true head dim's
    scale and slices the output back."""
    hd = q.shape[-1]
    pad = kernel_head_dim(kernel, hd) - hd
    if pad == 0:
        return q, k, v
    return tuple(torch.nn.functional.pad(x, (0, pad)) for x in (q, k, v))


def _kernel_operand(x):
    """`x` contiguous and 16-byte aligned, as the kernel's vector loads
    need (a copy only when it is not)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def flash_attention(q, k, v, causal=True, window=None):
    """q: [B, Sq, H, hd]; k/v: [B, Sk, KV, hd] -> [B, Sq, H, hd] in q's
    dtype, fp32 or bf16.  Query head h reads KV head h // (H // KV); the
    window applies to causal attention only.

    Every CUDA launch adds one to `flash_attention.launches` and to
    `flash_attention.launches_by_kernel[kernel_for(dtype, hd)]`.  On CUDA
    it raises where autograd would record the call (the kernel is forward
    only); the CPU's plain version is differentiable."""
    devices = {x.device for x in (q, k, v)}
    if len(devices) != 1:
        raise ValueError(f"flash_attention: inputs on several devices "
                         f"{devices}")
    device = next(iter(devices))
    if device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    if device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {device}")
    refuse_autograd("flash_attention", q, k, v)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q [B, Sq, H, hd] and k, v "
                         f"[B, Sk, KV, hd], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or KV == 0 or H % KV:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not fit "
                         f"q {tuple(q.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_attention: q, k, v must all be float32 or "
                         f"all bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    kernel = kernel_for(q.dtype, hd)
    if B == 0 or Sq == 0 or Sk == 0 or H > 65535 or B > 65535:
        raise ValueError(f"flash_attention: unsupported problem B={B} "
                         f"Sq={Sq} Sk={Sk} H={H}")
    q, k, v = (_kernel_operand(x) for x in padded_operands(q, k, v, kernel))
    o = torch.empty_like(q)
    shape = (B, Sq, Sk, H, KV, q.shape[-1], 1.0 / math.sqrt(hd),
             int(bool(causal)), int(window is not None),
             int(window) if window is not None else 0)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
        if kernel == "wgmma":
            rc = library().flash_attention_wgmma_fwd(*ptrs, *shape, stream)
        else:
            rc = library().flash_attention_fwd(*ptrs, _DTYPES[q.dtype],
                                               *shape, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention {kernel} kernel launch failed: "
                           f"error {rc} (a CUDA error, or 10000 + the "
                           f"driver's CUresult when a tensor map failed)")
    flash_attention.launches += 1
    flash_attention.launches_by_kernel[kernel] += 1
    return o if o.shape[-1] == hd else o[..., :hd].contiguous()


flash_attention.launches = 0
flash_attention.launches_by_kernel = {"wgmma": 0, "fma": 0}
