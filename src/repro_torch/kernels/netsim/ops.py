"""Engine-facing entry points of the netsim kernels.

`grant` (the oracle step's arbitration) and `cycle_core` (the fused and
compact steps' arbitration core) dispatch on the device of their
tensors: CPU tensors go to the plain PyTorch versions in `ref`; CUDA
tensors launch the hand-written kernels in ``csrc/grant.cu`` and
``csrc/cycle_core.cu`` (one library) or raise — there is no fallback.
They replace the TPU kernels `grant_pallas` and `cycle_core_pallas` of
`repro.kernels.netsim.kernel`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..build import load_library
from .ref import check_r2, cycle_core_ref, grant_ref

LIBRARY = "netsim"
SOURCES = [Path(__file__).parent / "csrc" / name
           for name in ("grant.cu", "cycle_core.cu")]
_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGTYPES = {
    "netsim_grant": [_P, _P, _P, _P, _P, _P, _L, _P, _L, _P, _P, _P, _I, _I,
                     _I, _I, _P],
    "netsim_cycle_core": [_P, _P, _P, _P, _P, _L, _P, _P, _P, _P, _I, _I,
                          _I, _P],
}


def library() -> ctypes.CDLL:
    """The built and loaded kernel library (built at first use)."""
    lib = load_library(LIBRARY, SOURCES)
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def _check(kernel, name, x, dtype, shape):
    if x.dtype != dtype or tuple(x.shape) != shape:
        raise ValueError(f"{kernel}: {name} must be {dtype} of shape "
                         f"{shape}, got {x.dtype} {tuple(x.shape)}")


def _one_device(kernel, args):
    devices = {x.device for x in args}
    if len(devices) != 1:
        raise ValueError(f"{kernel}: inputs on several devices {devices}")
    device = next(iter(devices))
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel}: unsupported device {device}")
    return device


def grant(out, itime, valid, ovc_count, is_eject, ch_busy, ch_alive,
          *, buf_pkts: int):
    """One winner per output channel, oldest `itime` first, row ids break
    ties — the same arguments and result as `ref.grant_ref`, with an
    optional leading lane dimension: row tensors ``[B?, N]``, channel
    tensors ``[B?, E]``; returns (win [B?, N] bool, won_ch [B?, E] bool).

    Every CUDA launch adds one to `grant.launches`."""
    args = (out, itime, valid, ovc_count, is_eject, ch_busy, ch_alive)
    if _one_device("grant", args).type == "cpu":
        return grant_ref(*args, buf_pkts=buf_pkts)
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
        _check("grant", name, x, dt, (B, N))
    _check("grant", "ch_busy", ch_busy, torch.int32, (B, E))
    _check("grant", "ch_alive", ch_alive, torch.bool, (B, E))
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


def cycle_core(out, itime, ok, ch_ok, *, r2: int, prio=None):
    """The fused and compact steps' arbitration core — the same arguments
    and result as `ref.cycle_core_ref`, with an optional leading lane
    dimension: row tensors ``[B?, N]``, ``ch_ok [B?, E]``; returns
    (won_ch [B?, E] bool, wprio [B?, E] int32, win [B?, N] bool).
    `prio=None` passes a null pointer: the kernel uses the row index.

    Every CUDA launch adds one to `cycle_core.launches`."""
    args = (out, itime, ok, ch_ok) + (() if prio is None else (prio,))
    if _one_device("cycle_core", args).type == "cpu":
        return cycle_core_ref(out, itime, ok, ch_ok, r2=r2, prio=prio)
    if out.dim() == 1:
        won, wprio, win = cycle_core(
            out[None], itime[None], ok[None], ch_ok[None], r2=r2,
            prio=None if prio is None else prio[None])
        return won[0], wprio[0], win[0]
    B, N = out.shape
    E = ch_ok.shape[-1]
    if B == 0 or N == 0 or E == 0:
        raise ValueError(f"cycle_core: empty problem B={B} N={N} E={E}")
    check_r2(r2, N, prio)
    rows = [x.contiguous() for x in args[:3]]
    names = ("out", "itime", "ok")
    dtypes = (torch.int32, torch.int32, torch.bool)
    if prio is not None:
        rows.append(prio.contiguous())
        names, dtypes = names + ("prio",), dtypes + (torch.int32,)
    for name, x, dt in zip(names, rows, dtypes):
        _check("cycle_core", name, x, dt, (B, N))
    _check("cycle_core", "ch_ok", ch_ok, torch.bool, (B, E))
    if ch_ok.stride(-1) != 1:
        raise ValueError("cycle_core: ch_ok must be contiguous along the "
                         "channel axis")
    won = torch.empty((B, E), dtype=torch.bool, device=out.device)
    wprio = torch.empty((B, E), dtype=torch.int32, device=out.device)
    win = torch.empty((B, N), dtype=torch.bool, device=out.device)
    keys = torch.empty((B, E), dtype=torch.int64, device=out.device)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = library().netsim_cycle_core(
            rows[0].data_ptr(), rows[1].data_ptr(), rows[2].data_ptr(),
            rows[3].data_ptr() if prio is not None else None,
            ch_ok.data_ptr(), ch_ok.stride(0), keys.data_ptr(),
            win.data_ptr(), won.data_ptr(), wprio.data_ptr(), B, N, E,
            stream)
    if rc != 0:
        raise RuntimeError(f"netsim cycle_core kernel launch failed: CUDA "
                           f"error {rc}")
    cycle_core.launches += 1
    return won, wprio, win


cycle_core.launches = 0
