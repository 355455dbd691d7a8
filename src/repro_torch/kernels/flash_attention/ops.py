"""Entry point of the flash-attention kernel (port of
`repro.kernels.flash_attention.ops`).

`flash_attention` dispatches on the device of its tensors: CPU tensors go
to the plain version `ref.attention_ref`; CUDA tensors launch the
hand-written kernel in ``csrc/flash_attention.cu`` or raise — there is no
fallback.  It replaces the TPU kernel `flash_attention_pallas` of
`repro.kernels.flash_attention.kernel`.  Unlike the reference wrapper it
pads nothing: the kernel takes the true head_dim and masks on the true
sequence lengths.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from ..build import load_library
from .ref import attention_ref

LIBRARY = "flash_attention"
SOURCES = [Path(__file__).parent / "csrc" / "flash_attention.cu"]
# the head dims the kernel is instantiated for (csrc/flash_attention.cu)
HEAD_DIMS = (16, 64, 80, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I,
             _I, _I, _P]


def library() -> ctypes.CDLL:
    """The built and loaded kernel library (built at first use)."""
    lib = load_library(LIBRARY, SOURCES)
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _kernel_operand(x):
    """`x` contiguous and 16-byte aligned, as the kernel's vector loads
    need (a copy only when it is not)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def flash_attention(q, k, v, causal=True, window=None):
    """q: [B, Sq, H, hd]; k/v: [B, Sk, KV, hd] -> [B, Sq, H, hd] in q's
    dtype, fp32 or bf16.  Query head h reads KV head h // (H // KV); the
    window applies to causal attention only.

    Every CUDA launch adds one to `flash_attention.launches`."""
    devices = {x.device for x in (q, k, v)}
    if len(devices) != 1:
        raise ValueError(f"flash_attention: inputs on several devices "
                         f"{devices}")
    device = next(iter(devices))
    if device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    if device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {device}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q [B, Sq, H, hd] and k, v "
                         f"[B, Sk, KV, hd], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or KV == 0 or H % KV:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not fit "
                         f"q {tuple(q.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: q, k, v must all be float32 or "
                         f"all bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in the "
                         f"kernel's {HEAD_DIMS}")
    if B == 0 or Sq == 0 or Sk == 0 or H > 65535 or B > 65535:
        raise ValueError(f"flash_attention: unsupported problem B={B} "
                         f"Sq={Sq} Sk={Sk} H={H}")
    q, k, v = (_kernel_operand(x) for x in (q, k, v))
    o = torch.empty_like(q)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = library().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            _DTYPES[q.dtype], B, Sq, Sk, H, KV, hd, 1.0 / math.sqrt(hd),
            int(bool(causal)), int(window is not None),
            int(window) if window is not None else 0, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error "
                           f"{rc}")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
