"""Entry point of the SSD scan kernels (port of
`repro.kernels.ssd_scan.ops`).

`ssd_scan` dispatches on the device of its tensors: CPU tensors go to the
plain version `ref.ssd_ref`; CUDA tensors launch one of two hand-written
kernels or raise — there is no fallback.  Which kernel is a static rule
on (dtype, head_dim P, d_state N), `kernel_for`: bf16 with N a multiple
of 16 runs the tensor-core kernel in ``csrc/ssd_scan_wgmma.cu`` (wgmma,
the state in registers, x, B and C read in place through their strides);
fp32, and bf16 at other N, the FMA kernel in ``csrc/ssd_scan.cu``.  Both
replace the TPU kernel `ssd_scan_pallas` of
`repro.kernels.ssd_scan.kernel`; bytes bound both on the H100 (each
source's note has the reckoning).  Unlike the reference wrapper they pad
nothing: they mask on the true sequence length and tile the sequence by
their own chunk.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import refuse_autograd
from ..build import load_library
from .ref import ssd_ref

LIBRARY = "ssd_scan"
SOURCES = [Path(__file__).parent / "csrc" / name
           for name in ("ssd_scan.cu", "ssd_scan_wgmma.cu")]
# the head dims P both kernels are instantiated for
HEAD_DIMS = (16, 32, 64)
MAX_STATE = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "ssd_scan_fwd": [_P] * 7 + [_I] * 6 + [_P],
    "ssd_scan_wgmma_fwd": [_P, _L, _L, _L, _P, _P, _P, _L, _L, _P, _L, _L,
                           _P, _P, _I, _I, _I, _I, _I, _P]}


def library(name: str = LIBRARY, sources=SOURCES) -> ctypes.CDLL:
    """The built and loaded kernel library (built at first use).  Another
    `name` with edited `sources` loads a variant of it beside it, as
    ``tools/ssd_phases.py`` does."""
    lib = load_library(name, sources)
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def kernel_for(dtype, head_dim, d_state) -> str:
    """The kernel a CUDA call at (dtype, P, N) launches: "wgmma" for bf16
    with N a multiple of 16, "fma" for fp32 and for bf16 at other N; P in
    `HEAD_DIMS` and 1 <= N <= `MAX_STATE` for both.  Raises on anything
    else."""
    if dtype not in _DTYPES:
        raise ValueError(f"ssd_scan: x, Bm, Cm must all be float32 or all "
                         f"bfloat16, got {dtype}")
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"ssd_scan: head_dim P = {head_dim} not in the "
                         f"kernels' {HEAD_DIMS}")
    if not 1 <= d_state <= MAX_STATE:
        raise ValueError(f"ssd_scan: d_state N = {d_state} not in "
                         f"1..{MAX_STATE}")
    if dtype == torch.bfloat16 and d_state % 16 == 0:
        return "wgmma"
    return "fma"


def _in_place(t):
    """`t` as the tensor-core kernel reads it: unit stride in the last dim,
    the other strides multiples of 8 elements (16 bytes) and a 16-byte
    aligned base, so that every row loads in 16-byte pieces.  A copy only
    when `t` is not so."""
    ok = (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
          and all(s % 8 == 0 for s, n in zip(t.stride()[:-1], t.shape[:-1])
                  if n > 1))
    if ok:
        return t
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def ssd_scan(x, dt, A, Bm, Cm, chunk=128, return_state=False):
    """x: [B, S, H, P]; dt: [B, S, H] (post-softplus); A: [H] (positive
    decay rate); Bm/Cm: [B, S, N], shared by all heads.  Returns y
    [B, S, H, P] in x's dtype and, with `return_state`, also the final
    state [B, H, P, N] in fp32.

    `chunk` is the reference's tile; the result does not depend on it, and
    the CUDA kernels use their own.  On CUDA, x, Bm and Cm are all float32
    or all bfloat16 and dt, A float32; the tensor-core kernel reads x, Bm
    and Cm in place (views with unit stride in P and N, as `ssm_apply`
    passes).  Every CUDA launch adds one to `ssd_scan.launches` and to
    `ssd_scan.launches_by_kernel[kernel_for(dtype, P, N)]`.  On CUDA it
    raises where autograd would record the call (the kernels are forward
    only); the CPU's plain version is differentiable."""
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
    refuse_autograd("ssd_scan", x, dt, A, Bm, Cm)
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
    if not (x.dtype == Bm.dtype == Cm.dtype):
        raise ValueError(f"ssd_scan: x, Bm, Cm must all be float32 or all "
                         f"bfloat16, got {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"ssd_scan: dt and A must be float32, got "
                         f"{dt.dtype}, {A.dtype}")
    kernel = kernel_for(x.dtype, P, N)
    if B == 0 or S == 0 or H == 0 or B > 65535:
        raise ValueError(f"ssd_scan: unsupported problem B={B} S={S} H={H}")
    dt, A = dt.contiguous(), A.contiguous()
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=device)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        if kernel == "wgmma":
            x, Bm, Cm = (_in_place(t) for t in (x, Bm, Cm))
            rc = library().ssd_scan_wgmma_fwd(
                x.data_ptr(), *x.stride()[:3], dt.data_ptr(), A.data_ptr(),
                Bm.data_ptr(), *Bm.stride()[:2], Cm.data_ptr(),
                *Cm.stride()[:2], y.data_ptr(), state.data_ptr(), B, S, H, P,
                N, stream)
        else:
            x, Bm, Cm = (t.contiguous() for t in (x, Bm, Cm))
            rc = library().ssd_scan_fwd(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), y.data_ptr(), state.data_ptr(),
                _DTYPES[x.dtype], B, S, H, P, N, stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan {kernel} kernel launch failed: CUDA "
                           f"error {rc}")
    ssd_scan.launches += 1
    ssd_scan.launches_by_kernel[kernel] += 1
    return (y, state) if return_state else y


ssd_scan.launches = 0
ssd_scan.launches_by_kernel = {"wgmma": 0, "fma": 0}
