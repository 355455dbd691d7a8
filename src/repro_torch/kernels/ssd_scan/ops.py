"""Entry point of the SSD scan kernel (port of
`repro.kernels.ssd_scan.ops`).

`ssd_scan` dispatches on the device of its tensors: CPU tensors go to the
plain version `ref.ssd_ref`; CUDA tensors launch the hand-written kernel
in ``csrc/ssd_scan.cu`` or raise — there is no fallback.  It replaces the
TPU kernel `ssd_scan_pallas` of `repro.kernels.ssd_scan.kernel`.  Unlike
the reference wrapper it pads nothing: the kernel masks on the true
sequence length, and tiles the sequence by its own chunk.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..build import load_library
from .ref import ssd_ref

LIBRARY = "ssd_scan"
SOURCES = [Path(__file__).parent / "csrc" / "ssd_scan.cu"]
# the head dims P the kernel is instantiated for (csrc/ssd_scan.cu)
HEAD_DIMS = (16, 32, 64)
MAX_STATE = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 7 + [_I] * 6 + [_P]


def library() -> ctypes.CDLL:
    """The built and loaded kernel library (built at first use)."""
    lib = load_library(LIBRARY, SOURCES)
    fn = lib.ssd_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def ssd_scan(x, dt, A, Bm, Cm, chunk=128, return_state=False):
    """x: [B, S, H, P]; dt: [B, S, H] (post-softplus); A: [H] (positive
    decay rate); Bm/Cm: [B, S, N], shared by all heads.  Returns y
    [B, S, H, P] in x's dtype and, with `return_state`, also the final
    state [B, H, P, N] in fp32.

    `chunk` is the reference's tile; the result does not depend on it, and
    the CUDA kernel uses its own.  On CUDA, x, Bm and Cm are all float32
    or all bfloat16 and dt, A float32.  Every CUDA launch adds one to
    `ssd_scan.launches`."""
    devices = {t.device for t in (x, dt, A, Bm, Cm)}
    if len(devices) != 1:
        raise ValueError(f"ssd_scan: inputs on several devices {devices}")
    if int(chunk) < 1:
        raise ValueError(f"ssd_scan: chunk {chunk} < 1")
    device = next(iter(devices))
    if device.type == "cpu":
        y, state = ssd_ref(x, dt, A, Bm, Cm)
        return (y, state) if return_state else y
    if device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {device}")
    if x.dim() != 4:
        raise ValueError(f"ssd_scan: x is [B, S, H, P], got "
                         f"{tuple(x.shape)}")
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if (tuple(dt.shape) != (B, S, H) or tuple(A.shape) != (H,)
            or tuple(Bm.shape) != (B, S, N) or Cm.shape != Bm.shape):
        raise ValueError(f"ssd_scan: dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)}, Bm {tuple(Bm.shape)}, Cm "
                         f"{tuple(Cm.shape)} do not fit x {tuple(x.shape)}")
    if not (x.dtype == Bm.dtype == Cm.dtype) or x.dtype not in _DTYPES:
        raise ValueError(f"ssd_scan: x, Bm, Cm must all be float32 or all "
                         f"bfloat16, got {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"ssd_scan: dt and A must be float32, got "
                         f"{dt.dtype}, {A.dtype}")
    if P not in HEAD_DIMS:
        raise ValueError(f"ssd_scan: head_dim P = {P} not in the kernel's "
                         f"{HEAD_DIMS}")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"ssd_scan: d_state N = {N} not in 1..{MAX_STATE}")
    if B == 0 or S == 0 or H == 0 or B > 65535:
        raise ValueError(f"ssd_scan: unsupported problem B={B} S={S} H={H}")
    x, dt, A, Bm, Cm = (t.contiguous() for t in (x, dt, A, Bm, Cm))
    y = torch.empty_like(x)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = library().ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), state.data_ptr(), _DTYPES[x.dtype],
            B, S, H, P, N, stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {rc}")
    ssd_scan.launches += 1
    return (y, state) if return_state else y


ssd_scan.launches = 0
