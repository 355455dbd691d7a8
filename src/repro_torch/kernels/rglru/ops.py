"""Entry point of the RG-LRU scan kernel (port of
`repro.kernels.rglru.ops`).

`rglru_scan` dispatches on the device of its tensors: CPU tensors go to
the plain version `ref.rglru_scan_ref`; CUDA tensors launch the
hand-written kernel in ``csrc/rglru.cu`` or raise — there is no fallback.
It replaces the TPU kernel `rglru_scan_pallas` of
`repro.kernels.rglru.kernel`.  Unlike the reference wrapper it pads
nothing: one thread runs each (batch, channel) chain over the true
length.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..build import load_library
from .ref import rglru_scan_ref

LIBRARY = "rglru"
SOURCES = [Path(__file__).parent / "csrc" / "rglru.cu"]
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _I, _I, _I, _P]


def library() -> ctypes.CDLL:
    """The built and loaded kernel library (built at first use)."""
    lib = load_library(LIBRARY, SOURCES)
    fn = lib.rglru_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def rglru_scan(a, b, chunk=256, block_r=512):
    """h_t = a_t h_{t-1} + b_t from h = 0.  a, b: [B, S, R] float32 ->
    h [B, S, R] float32.

    `chunk` and `block_r` are the reference's tiles; the result does not
    depend on them, and the CUDA kernel has none.  Every CUDA launch adds
    one to `rglru_scan.launches`."""
    if a.device != b.device:
        raise ValueError(f"rglru_scan: a on {a.device}, b on {b.device}")
    if int(chunk) < 1 or int(block_r) < 1:
        raise ValueError(f"rglru_scan: chunk {chunk}, block_r {block_r} "
                         f"must be positive")
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan: unsupported device {a.device}")
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"rglru_scan: a and b are [B, S, R], got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"rglru_scan: a and b must be float32, got "
                         f"{a.dtype}, {b.dtype}")
    B, S, R = a.shape
    if B == 0 or S == 0 or R == 0 or B > 65535:
        raise ValueError(f"rglru_scan: unsupported problem B={B} S={S} "
                         f"R={R}")
    a, b = a.contiguous(), b.contiguous()
    h = torch.empty_like(a)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = library().rglru_scan_fwd(a.data_ptr(), b.data_ptr(),
                                      h.data_ptr(), B, S, R, stream)
    if rc != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: CUDA error "
                           f"{rc}")
    rglru_scan.launches += 1
    return h


rglru_scan.launches = 0
