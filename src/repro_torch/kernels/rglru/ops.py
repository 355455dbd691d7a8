"""Entry point of the RG-LRU scan kernels (port of
`repro.kernels.rglru.ops`).

`rglru_scan` dispatches on the device of its tensors: CPU tensors go to
the plain version `ref.rglru_scan_ref`; CUDA tensors launch a
hand-written kernel or raise — there is no fallback.  Both kernels, in
the one ``rglru`` library, replace the TPU kernel `rglru_scan_pallas` of
`repro.kernels.rglru.kernel`, and both run each (batch, channel) chain
sequentially with one fused multiply-add a step, so they agree bit for
bit:

- "ring" (``csrc/rglru_ring.cu``): one warp a block, 32 channels, a and b
  fed through a ring of stages in shared memory copied several stages
  ahead.  Every CUDA call runs it (`kernel_for`).
- "direct" (``csrc/rglru.cu``): one thread a chain, loading 16 steps
  ahead.  It runs only when a call names it (`kernel=`), as the tests and
  ``chip_smoke.py`` do to hold and time the ring kernel against it.

Unlike the reference wrapper neither pads anything: they mask on the true
sequence length and channel count.  Launches are counted in total and per
kernel (`rglru_scan.launches`, `rglru_scan.launches_by_kernel`).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import refuse_autograd
from ..build import load_library
from .ref import rglru_scan_ref

LIBRARY = "rglru"
SOURCES = [Path(__file__).parent / "csrc" / name
           for name in ("rglru.cu", "rglru_ring.cu")]
KERNELS = ("ring", "direct")
_FUNCTIONS = {"direct": "rglru_scan_fwd", "ring": "rglru_scan_ring_fwd"}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _I, _I, _I, _P]


def library(name: str = LIBRARY, sources=SOURCES) -> ctypes.CDLL:
    """The built and loaded kernel library (built at first use).  Another
    `name` with edited `sources` loads a variant of it beside it, as
    ``tools/rglru_phases.py`` does."""
    lib = load_library(name, sources)
    for fn_name in _FUNCTIONS.values():
        fn = getattr(lib, fn_name)
        if fn.argtypes is None:
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
    return lib


def kernel_for() -> str:
    """The kernel a CUDA call launches: "ring", for every fp32 call."""
    return "ring"


def rglru_scan(a, b, chunk=256, block_r=512, *, kernel: str | None = None):
    """h_t = a_t h_{t-1} + b_t from h = 0.  a, b: [B, S, R] float32 ->
    h [B, S, R] float32.

    `chunk` and `block_r` are the reference's tiles; the result does not
    depend on them, and the CUDA kernels have none.  `kernel` names the
    CUDA kernel ("ring" or "direct"; None: `kernel_for`).  Every CUDA
    launch adds one to `rglru_scan.launches` and to
    `rglru_scan.launches_by_kernel[kernel]`.  On CUDA it raises where
    autograd would record the call (the kernels are forward only); the
    CPU's plain version is differentiable."""
    if a.device != b.device:
        raise ValueError(f"rglru_scan: a on {a.device}, b on {b.device}")
    if int(chunk) < 1 or int(block_r) < 1:
        raise ValueError(f"rglru_scan: chunk {chunk}, block_r {block_r} "
                         f"must be positive")
    if kernel is not None and kernel not in KERNELS:
        raise ValueError(f"rglru_scan: kernel must be one of {KERNELS} or "
                         f"None, got {kernel!r}")
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan: unsupported device {a.device}")
    refuse_autograd("rglru_scan", a, b)
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
    kernel = kernel or kernel_for()
    a, b = a.contiguous(), b.contiguous()
    h = torch.empty_like(a)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        fn = getattr(library(), _FUNCTIONS[kernel])
        rc = fn(a.data_ptr(), b.data_ptr(), h.data_ptr(), B, S, R, stream)
    if rc != 0:
        raise RuntimeError(f"rglru_scan {kernel} kernel launch failed: CUDA "
                           f"error {rc}")
    rglru_scan.launches += 1
    rglru_scan.launches_by_kernel[kernel] += 1
    return h


rglru_scan.launches = 0
rglru_scan.launches_by_kernel = dict.fromkeys(KERNELS, 0)
