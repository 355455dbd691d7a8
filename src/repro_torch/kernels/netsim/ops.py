"""Engine-facing entry point of the netsim grant kernel.

`grant` dispatches on the device of its tensors: CPU tensors go to the
plain PyTorch version `ref.grant_ref`; CUDA tensors launch the
hand-written kernel in ``csrc/grant.cu`` or raise — there is no fallback.
The kernel replaces the TPU kernel `_kernel` / `grant_pallas` of
`repro.kernels.netsim.kernel`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..build import load_library
from .ref import grant_ref

LIBRARY = "netsim"
SOURCES = [Path(__file__).parent / "csrc" / "grant.cu"]


def library() -> ctypes.CDLL:
    """The built and loaded kernel library (built at first use)."""
    lib = load_library(LIBRARY, SOURCES)
    fn = lib.netsim_grant
    if fn.argtypes is None:
        P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, L, P, L, P, P, P, I, I, I, I, P]
        fn.restype = ctypes.c_int
    return lib


def _check(name, x, dtype, shape):
    if x.dtype != dtype or tuple(x.shape) != shape:
        raise ValueError(f"grant: {name} must be {dtype} of shape {shape}, "
                         f"got {x.dtype} {tuple(x.shape)}")


def grant(out, itime, valid, ovc_count, is_eject, ch_busy, ch_alive,
          *, buf_pkts: int):
    """One winner per output channel, oldest `itime` first, row ids break
    ties — the same arguments and result as `ref.grant_ref`, with an
    optional leading lane dimension: row tensors ``[B?, N]``, channel
    tensors ``[B?, E]``; returns (win [B?, N] bool, won_ch [B?, E] bool).

    Every CUDA launch adds one to `grant.launches`."""
    args = (out, itime, valid, ovc_count, is_eject, ch_busy, ch_alive)
    devices = {x.device for x in args}
    if len(devices) != 1:
        raise ValueError(f"grant: inputs on several devices {devices}")
    if out.device.type == "cpu":
        return grant_ref(*args, buf_pkts=buf_pkts)
    if out.device.type != "cuda":
        raise ValueError(f"grant: unsupported device {out.device}")
    if out.dim() == 1:
        win, won = grant(*(x[None] for x in args), buf_pkts=buf_pkts)
        return win[0], won[0]
    B, N = out.shape
    E = ch_busy.shape[-1]
    if B == 0 or N == 0 or E == 0:
        raise ValueError(f"grant: empty problem B={B} N={N} E={E}")
    rows = [x.contiguous() for x in (out, itime, valid, ovc_count, is_eject)]
    for name, x, dt in zip(("out", "itime", "valid", "ovc_count", "is_eject"),
                           rows, (torch.int32, torch.int32, torch.bool,
                                  torch.int32, torch.bool)):
        _check(name, x, dt, (B, N))
    _check("ch_busy", ch_busy, torch.int32, (B, E))
    _check("ch_alive", ch_alive, torch.bool, (B, E))
    if ch_busy.stride(-1) != 1 or ch_alive.stride(-1) != 1:
        raise ValueError("grant: channel tensors must be contiguous along "
                         "the channel axis")
    win = torch.empty((B, N), dtype=torch.bool, device=out.device)
    won = torch.empty((B, E), dtype=torch.bool, device=out.device)
    keys = torch.empty((B, E), dtype=torch.int64, device=out.device)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = library().netsim_grant(
            *(x.data_ptr() for x in rows),
            ch_busy.data_ptr(), ch_busy.stride(0),
            ch_alive.data_ptr(), ch_alive.stride(0),
            keys.data_ptr(), win.data_ptr(), won.data_ptr(),
            B, N, E, int(buf_pkts), stream)
    if rc != 0:
        raise RuntimeError(f"netsim grant kernel launch failed: CUDA error "
                           f"{rc}")
    grant.launches += 1
    return win, won


grant.launches = 0
