"""Engine-facing entry points of the netsim kernels.

`grant` (the oracle step's arbitration) and `cycle_core` (the fused and
compact steps' arbitration core) dispatch on the device of their
tensors: CPU tensors go to the plain PyTorch versions in `ref`; CUDA
tensors launch a hand-written kernel or raise — there is no fallback.
They replace the TPU kernels `grant_pallas` and `cycle_core_pallas` of
`repro.kernels.netsim.kernel`.

Each has two kernels in the one ``netsim`` library, and a static rule on
the call's priority, `kernel_for(explicit_prio)`, picks between them:

- "coop" (``csrc/grant_coop.cu``, ``csrc/cycle_core_coop.cu`` on the
  skeleton ``csrc/arbiter.cuh``): one persistent cooperative launch, the
  per-channel minimum in L2, one grid barrier, each row read once; for the
  row-index priority (every `grant` call; `cycle_core` with prio=None,
  the fused step), at any shape.  It keeps a scratch table between calls
  (`_scratch`);
- "three_pass" (``csrc/cycle_core.cu``): fill, accumulate and emit
  launches with the minimum in device memory, for an explicit priority
  (`cycle_core` with prio, the compact step), where it measured faster.
  ``csrc/grant.cu``, its `grant` form, runs only when a call names it.

A call may name its kernel (`kernel=`), as the tests and ``chip_smoke.py``
do to hold both to the plain versions and to time them against each
other.  Launches are counted per wrapper and per kernel twice: on the
host where a wrapper launches (`launches`, `launches_by_kernel`; a launch
recorded into a CUDA graph counts once, at its recording), and on the
device by the kernel itself (`device_launches`), which counts every
replay of a graph too.

`head_records_dense` and `head_records_picked` (``csrc/head_records.cu``)
gather the fused step's 32-byte buffer records, one thread a record:
every buffer head, and one record a channel by index.  Their launches
are counted as the arbitration wrappers' are, under the one wrapper name
`head_records` (its "kernels" the two forms, "dense" and "picked").

`threefry_split`, `threefry_bits`, `threefry_uniform`, `threefry_randint`
and `threefry_bernoulli` (``csrc/threefry.cu``) are the draws of the
port's PRNG, `repro_torch.random`: on a CUDA key one launch a draw, one
thread an output element; on a CPU key the plain versions in `ref`, the
same bits.  They are counted under the wrapper name `threefry`, one
"kernel" a form.
"""
from __future__ import annotations

import ctypes
import math
from collections import OrderedDict
from pathlib import Path
from types import SimpleNamespace

import torch

from ..build import load_library
from .ref import (check_r2, cycle_core_ref, grant_ref,
                  head_records_dense_ref, head_records_picked_ref,
                  randint_span, threefry_bernoulli_ref, threefry_bits_ref,
                  threefry_randint_ref, threefry_split_ref,
                  threefry_uniform_ref)

LIBRARY = "netsim"
SOURCES = [Path(__file__).parent / "csrc" / name
           for name in ("grant.cu", "cycle_core.cu", "grant_coop.cu",
                        "cycle_core_coop.cu", "head_records.cu",
                        "threefry.cu")]
KERNELS = ("coop", "three_pass")
HEAD_FORMS = ("dense", "picked")
# the draws of `threefry.cu`, in the order of its `form` argument
THREEFRY_FORMS = ("split", "bits", "uniform", "randint", "bernoulli")
# int32 fields a buffer record: the state's NUM_FUSED_FIELDS
RECORD_FIELDS = 8
# the three-pass kernels' grid puts the lanes on its y dimension
MAX_LANES = 65_535
_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_U = ctypes.c_uint
_ARGTYPES = {
    "netsim_grant": [_P, _P, _P, _P, _P, _P, _L, _P, _L, _P, _P, _P, _I, _I,
                     _I, _I, _P, _P],
    "netsim_cycle_core": [_P, _P, _P, _P, _P, _L, _P, _P, _P, _P, _I, _I,
                          _I, _P, _P],
    "netsim_grant_coop": [_P, _P, _P, _P, _P, _P, _L, _P, _L, _P, _P, _P,
                          _I, _I, _I, _I, _P, _P],
    "netsim_cycle_core_coop": [_P, _P, _P, _P, _L, _P, _P, _P, _P, _I, _I,
                               _I, _P, _P],
    "netsim_head_records_dense": [_P, _L, _L, _L, _L, _P, _L, _L, _L, _P,
                                  _I, _I, _I, _I, _P, _P],
    "netsim_head_records_picked": [_P, _L, _L, _I, _P, _L, _L, _P, _I, _I,
                                   _P, _P],
    "netsim_threefry": [_I, _P, _L, _L, _I, _I, _P, _U, _U, _U,
                        ctypes.c_float, _P, _P],
}
# library name -> {function name: the bound ctypes function}, bound once
_BOUND: dict = {}
# (device, stream, B, E) -> the coop kernel's scratch, kept between calls
_SCRATCH: OrderedDict = OrderedDict()
_SCRATCH_KEPT = 8
WRAPPERS = ("grant", "cycle_core", "head_records", "threefry")
# wrapper -> the kernels it launches, in the order of its device counts
WRAPPER_KERNELS = {"grant": KERNELS, "cycle_core": KERNELS,
                   "head_records": HEAD_FORMS, "threefry": THREEFRY_FORMS}
_WIDTH = max(map(len, WRAPPER_KERNELS.values()))
# device -> int64 [wrapper, kernel]: the launches the kernels counted
_DEVICE_LAUNCHES: dict = {}


def library(name: str = LIBRARY, sources=SOURCES) -> ctypes.CDLL:
    """The built and loaded kernel library (built at first use), its
    functions bound once.  Another `name` with edited `sources` loads a
    variant of it beside it, as ``tools/netsim_phases.py`` does."""
    lib = load_library(name, sources)
    if name not in _BOUND:
        bound = {}
        for fn_name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            bound[fn_name] = fn
        _BOUND[name] = bound
    return lib


def _fn(name):
    bound = _BOUND.get(LIBRARY)
    if bound is None:
        library()
        bound = _BOUND[LIBRARY]
    return bound[name]


def kernel_for(explicit_prio: bool = False) -> str:
    """The kernel a CUDA call launches: "coop" for the row-index priority
    (the oracle step's grant, the fused step), "three_pass" for an explicit
    priority (the compact step), which the coop kernel does not take."""
    return "three_pass" if explicit_prio else "coop"


def _scratch(device, stream, B, E):
    """The coop kernel's scratch for calls on `stream` at (B, E): the two
    halves of the table [2, B, E] (all ones) and the arrival and call
    counts (0), kept for the next call; the last `_SCRATCH_KEPT` shapes
    are kept."""
    key = (device, stream, B, E)
    scratch = _SCRATCH.get(key)
    if scratch is None:
        scratch = torch.full((2 * B * E + 2,), -1, dtype=torch.int64,
                             device=device)
        scratch[-2:] = 0
        _SCRATCH[key] = scratch
        while len(_SCRATCH) > _SCRATCH_KEPT:
            _SCRATCH.popitem(last=False)
    return scratch


def _launch_slot(device, wrapper, kernel) -> int:
    """The address of the device count that `wrapper`'s `kernel` adds one
    to at each launch.  The counts are made by the first eager call on
    `device` (a graph capture must not make them: it would record their
    zeroing and replay it)."""
    counts = _DEVICE_LAUNCHES.get(device)
    if counts is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("netsim: call a kernel once outside a CUDA "
                               "graph capture before capturing it")
        counts = _DEVICE_LAUNCHES[device] = torch.zeros(
            (len(WRAPPERS), _WIDTH), dtype=torch.int64, device=device)
    # int64 [wrapper, kernel], row-major
    slot = WRAPPERS.index(wrapper) * _WIDTH \
        + WRAPPER_KERNELS[wrapper].index(kernel)
    return counts.data_ptr() + 8 * slot


def device_launches(device=None) -> dict:
    """{wrapper: {kernel: launches}} as the kernels counted them on
    `device` (default: the current CUDA device) since the first call there:
    every eager launch and every replay of a captured one.  Reads the
    device, so it waits for the work issued so far."""
    device = torch.device("cuda", torch.cuda.current_device()) \
        if device is None else torch.device(device)
    counts = _DEVICE_LAUNCHES.get(device)
    rows = ([[0] * _WIDTH] * len(WRAPPERS) if counts is None
            else counts.cpu().tolist())
    return {w: dict(zip(WRAPPER_KERNELS[w], row))
            for w, row in zip(WRAPPERS, rows)}


def _check(kernel, name, x, dtype, shape):
    if x.dtype != dtype or tuple(x.shape) != shape:
        raise ValueError(f"{kernel}: {name} must be {dtype} of shape "
                         f"{shape}, got {x.dtype} {tuple(x.shape)}")


def _one_device(kernel, args):
    device = args[0].device
    for x in args:
        if x.device != device:
            raise ValueError(f"{kernel}: inputs on several devices "
                             f"{ {y.device for y in args} }")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel}: unsupported device {device}")
    return device


def _pick(name, kernel, B, explicit_prio=False):
    """`kernel` checked against the call, or the rule's pick."""
    if kernel is None:
        kernel = kernel_for(explicit_prio)
    if kernel == "coop" and explicit_prio:
        raise ValueError(f"{name}: the coop kernel takes the row-index "
                         f"priority only (prio=None)")
    if kernel == "three_pass" and B > MAX_LANES:
        raise ValueError(f"{name}: the three-pass kernel takes at most "
                         f"{MAX_LANES} lanes, got {B}")
    return kernel


def _checked_kernel(name, kernel):
    if kernel is not None and kernel not in KERNELS:
        raise ValueError(f"{name}: kernel must be one of {KERNELS} or None, "
                         f"got {kernel!r}")


def _rows(kernel, names, tensors, dtypes, shape):
    rows = []
    for name, x, dt in zip(names, tensors, dtypes):
        if not x.is_contiguous():
            x = x.contiguous()
        _check(kernel, name, x, dt, shape)
        rows.append(x)
    return rows


def _on_current_device(device):
    """Whether `device` is the current CUDA device (a launch runs on the
    current device; the wrappers enter the context only when it is not)."""
    return device.index is None or device.index == \
        torch.cuda.current_device()


def _stream():
    """The current device's current stream.  The raw handle costs 0.13 us
    a call against 5.8 us for `torch.cuda.current_stream().cuda_stream`
    (NVIDIA H100)."""
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())


def grant_operands(out, itime, valid, ovc_count, is_eject, ch_busy,
                   ch_alive):
    """The kernel's operands, checked: (row tensors made contiguous, B, N,
    E).  Raises ValueError on a wrong dtype, shape or stride."""
    B, N = out.shape
    E = ch_busy.shape[-1]
    if B == 0 or N == 0 or E == 0:
        raise ValueError(f"grant: empty problem B={B} N={N} E={E}")
    rows = _rows("grant", ("out", "itime", "valid", "ovc_count", "is_eject"),
                 (out, itime, valid, ovc_count, is_eject),
                 (torch.int32, torch.int32, torch.bool, torch.int32,
                  torch.bool), (B, N))
    _check("grant", "ch_busy", ch_busy, torch.int32, (B, E))
    _check("grant", "ch_alive", ch_alive, torch.bool, (B, E))
    if ch_busy.stride(-1) != 1 or ch_alive.stride(-1) != 1:
        raise ValueError("grant: channel tensors must be contiguous along "
                         "the channel axis")
    return rows, B, N, E


def grant(out, itime, valid, ovc_count, is_eject, ch_busy, ch_alive,
          *, buf_pkts: int, kernel: str | None = None):
    """One winner per output channel, oldest `itime` first, row ids break
    ties — the same arguments and result as `ref.grant_ref`, with an
    optional leading lane dimension: row tensors ``[B?, N]``, channel
    tensors ``[B?, E]``; returns (win [B?, N] bool, won_ch [B?, E] bool).
    `kernel` names the CUDA kernel ("coop" or "three_pass"; None:
    `kernel_for`).

    Every CUDA launch adds one to `grant.launches` and to
    `grant.launches_by_kernel[kernel]`, and the kernel adds one to its
    `device_launches` count each time it runs."""
    args = (out, itime, valid, ovc_count, is_eject, ch_busy, ch_alive)
    device = _one_device("grant", args)
    _checked_kernel("grant", kernel)
    if device.type == "cpu":
        return grant_ref(*args, buf_pkts=buf_pkts)
    if out.dim() == 1:
        win, won = grant(*(x[None] for x in args), buf_pkts=buf_pkts,
                         kernel=kernel)
        return win[0], won[0]
    if not _on_current_device(device):
        with torch.cuda.device(device):
            return grant(*args, buf_pkts=buf_pkts, kernel=kernel)
    rows, B, N, E = grant_operands(*args)
    kernel = _pick("grant", kernel, B)
    win = torch.empty((B, N), dtype=torch.bool, device=device)
    won = torch.empty((B, E), dtype=torch.bool, device=device)
    stream = _stream()
    ptrs = [x.data_ptr() for x in rows]
    channels = (ch_busy.data_ptr(), ch_busy.stride(0), ch_alive.data_ptr(),
                ch_alive.stride(0))
    table = (_scratch(device, stream, B, E) if kernel == "coop" else
             torch.empty((B, E), dtype=torch.int64, device=device))
    rc = _fn(f"netsim_grant{'_coop' if kernel == 'coop' else ''}")(
        *ptrs, *channels, table.data_ptr(), win.data_ptr(), won.data_ptr(),
        B, N, E, int(buf_pkts), _launch_slot(device, "grant", kernel),
        stream)
    if rc != 0:
        raise RuntimeError(f"netsim grant {kernel} kernel launch failed: "
                           f"CUDA error {rc}")
    grant.launches += 1
    grant.launches_by_kernel[kernel] += 1
    return win, won


grant.launches = 0
grant.launches_by_kernel = dict.fromkeys(KERNELS, 0)


def cycle_core_operands(out, itime, ok, ch_ok, r2, prio=None):
    """The kernel's operands, checked: (row tensors made contiguous — out,
    itime, ok and prio if given —, B, N, E).  Raises ValueError on a wrong
    r2, dtype, shape or stride."""
    B, N = out.shape
    E = ch_ok.shape[-1]
    if B == 0 or N == 0 or E == 0:
        raise ValueError(f"cycle_core: empty problem B={B} N={N} E={E}")
    check_r2(r2, N, prio)
    names = ("out", "itime", "ok")
    tensors = (out, itime, ok)
    dtypes = (torch.int32, torch.int32, torch.bool)
    if prio is not None:
        names, tensors = names + ("prio",), tensors + (prio,)
        dtypes = dtypes + (torch.int32,)
    rows = _rows("cycle_core", names, tensors, dtypes, (B, N))
    _check("cycle_core", "ch_ok", ch_ok, torch.bool, (B, E))
    if ch_ok.stride(-1) != 1:
        raise ValueError("cycle_core: ch_ok must be contiguous along the "
                         "channel axis")
    return rows, B, N, E


def cycle_core(out, itime, ok, ch_ok, *, r2: int, prio=None,
               kernel: str | None = None):
    """The fused and compact steps' arbitration core — the same arguments
    and result as `ref.cycle_core_ref`, with an optional leading lane
    dimension: row tensors ``[B?, N]``, ``ch_ok [B?, E]``; returns
    (won_ch [B?, E] bool, wprio [B?, E] int32, win [B?, N] bool).
    `prio=None` passes a null pointer: the kernel uses the row index.
    `kernel` names the CUDA kernel ("coop", row-index priority only, or
    "three_pass"; None: `kernel_for`).

    Every CUDA launch adds one to `cycle_core.launches` and to
    `cycle_core.launches_by_kernel[kernel]`, and the kernel adds one to its
    `device_launches` count each time it runs."""
    args = (out, itime, ok, ch_ok) + (() if prio is None else (prio,))
    device = _one_device("cycle_core", args)
    _checked_kernel("cycle_core", kernel)
    if device.type == "cpu":
        return cycle_core_ref(out, itime, ok, ch_ok, r2=r2, prio=prio)
    if out.dim() == 1:
        won, wprio, win = cycle_core(
            out[None], itime[None], ok[None], ch_ok[None], r2=r2,
            prio=None if prio is None else prio[None], kernel=kernel)
        return won[0], wprio[0], win[0]
    if not _on_current_device(device):
        with torch.cuda.device(device):
            return cycle_core(out, itime, ok, ch_ok, r2=r2, prio=prio,
                              kernel=kernel)
    rows, B, N, E = cycle_core_operands(out, itime, ok, ch_ok, r2, prio)
    kernel = _pick("cycle_core", kernel, B, prio is not None)
    won = torch.empty((B, E), dtype=torch.bool, device=device)
    wprio = torch.empty((B, E), dtype=torch.int32, device=device)
    win = torch.empty((B, N), dtype=torch.bool, device=device)
    stream = _stream()
    ptrs = [x.data_ptr() for x in rows]
    outs = (win.data_ptr(), won.data_ptr(), wprio.data_ptr(), B, N, E,
            _launch_slot(device, "cycle_core", kernel), stream)
    if kernel == "coop":
        rc = _fn("netsim_cycle_core_coop")(
            *ptrs, ch_ok.data_ptr(), ch_ok.stride(0),
            _scratch(device, stream, B, E).data_ptr(), *outs)
    else:
        keys = torch.empty((B, E), dtype=torch.int64, device=device)
        rc = _fn("netsim_cycle_core")(
            *ptrs[:3], ptrs[3] if prio is not None else None,
            ch_ok.data_ptr(), ch_ok.stride(0), keys.data_ptr(), *outs)
    if rc != 0:
        raise RuntimeError(f"netsim cycle_core {kernel} kernel launch "
                           f"failed: CUDA error {rc}")
    cycle_core.launches += 1
    cycle_core.launches_by_kernel[kernel] += 1
    return won, wprio, win


cycle_core.launches = 0
cycle_core.launches_by_kernel = dict.fromkeys(KERNELS, 0)


def _record_table(name, x, nd):
    """`x` checked as a table of 32-byte records the kernel may read with
    16-byte loads: int32, `nd` dims, the record's fields contiguous, every
    other stride a multiple of 4 fields, the base 16-byte aligned."""
    if x.dtype != torch.int32 or x.dim() != nd:
        raise ValueError(f"head_records: {name} must be int32 with {nd} "
                         f"dims, got {x.dtype} {tuple(x.shape)}")
    if x.shape[-1] * x.element_size() != 4 * RECORD_FIELDS \
            or x.stride(-1) != 1:
        raise ValueError(f"head_records: {name}'s records must be "
                         f"{RECORD_FIELDS} contiguous int32 (32 bytes), got "
                         f"{x.shape[-1]} fields at stride {x.stride(-1)}")
    if x.data_ptr() % 16 or any(st % 4 for st in x.stride()[:-1]):
        raise ValueError(f"head_records: {name}'s records must be 16-byte "
                         f"aligned (base {x.data_ptr():#x}, strides "
                         f"{x.stride()})")


def _record_index(name, index, B, nd):
    if index.dtype != torch.int32 or index.dim() != nd \
            or index.shape[0] != B:
        raise ValueError(f"head_records: {name} must be int32 with {nd} "
                         f"dims and {B} lanes, got {index.dtype} "
                         f"{tuple(index.shape)}")


def _launch_records(form, args, out):
    """Launch the `form` gather of `args` into `out` [B, rows, 8] on the
    current stream and count it: `head_records.launches` and
    `head_records.launches_by_kernel[form]` on the host, its
    `device_launches` slot on the device."""
    total = out.shape[0] * out.shape[1]
    if total >= 2**31:
        raise ValueError(f"head_records: {total} records exceed the "
                         f"kernel's 32-bit record index")
    if total == 0:
        return out
    rc = _fn(f"netsim_head_records_{form}")(
        *args, total, _launch_slot(out.device, "head_records", form),
        _stream())
    if rc != 0:
        raise RuntimeError(f"netsim head_records {form} kernel launch "
                           f"failed: CUDA error {rc}")
    head_records.launches += 1
    head_records.launches_by_kernel[form] += 1
    return out


def head_records_dense(store, b_head, rows: int):
    """Every buffer head of the first `rows` channels: the same arguments
    and result as `ref.head_records_dense_ref` (``store [B, E', NV, S,
    8]`` at the int32 ``b_head [B, E'', NV]``, into ``[B, rows * NV,
    8]``).  Records are int32, 32 bytes, their bases 16-byte aligned; a
    CUDA call raises ValueError otherwise."""
    device = _one_device("head_records", (store, b_head))
    if device.type == "cpu":
        return head_records_dense_ref(store, b_head, rows)
    if not _on_current_device(device):
        with torch.cuda.device(device):
            return head_records_dense(store, b_head, rows)
    _record_table("store", store, 5)
    B, Es, NV, S, _ = store.shape
    _record_index("b_head", b_head, B, 3)
    rows = int(rows)
    if b_head.shape[2] != NV or not 0 <= rows <= min(Es, b_head.shape[1]) \
            or S == 0:
        raise ValueError(f"head_records: b_head {tuple(b_head.shape)} and "
                         f"{rows} rows do not fit the store "
                         f"{tuple(store.shape)}")
    out = torch.empty((B, rows * NV, RECORD_FIELDS), dtype=torch.int32,
                      device=device)
    return _launch_records(
        "dense", (store.data_ptr(), *store.stride()[:4], b_head.data_ptr(),
                  *b_head.stride(), out.data_ptr(), rows, NV, S), out)


def head_records_picked(head, idx):
    """The records ``head[b, idx[b, c]]``: the same arguments and result
    as `ref.head_records_picked_ref` (``head [B, R, 8]`` at the int32
    ``idx [B, E]``, wrapped once and clamped, into ``[B, E, 8]``).
    Records are int32, 32 bytes, their bases 16-byte aligned; a CUDA call
    raises ValueError otherwise."""
    device = _one_device("head_records", (head, idx))
    if device.type == "cpu":
        return head_records_picked_ref(head, idx)
    if not _on_current_device(device):
        with torch.cuda.device(device):
            return head_records_picked(head, idx)
    _record_table("head", head, 3)
    B, R, _ = head.shape
    _record_index("idx", idx, B, 2)
    if R == 0:
        raise ValueError(f"head_records: picks {tuple(idx.shape)} do not "
                         f"fit the head {tuple(head.shape)}")
    out = torch.empty((B, idx.shape[1], RECORD_FIELDS), dtype=torch.int32,
                      device=device)
    return _launch_records(
        "picked", (head.data_ptr(), head.stride(0), head.stride(1), R,
                   idx.data_ptr(), *idx.stride(), out.data_ptr(),
                   idx.shape[1]), out)


# the host counts of both gathers, by form, under the wrapper name that
# `WRAPPERS` and `device_launches` give them
head_records = SimpleNamespace(launches=0,
                               launches_by_kernel=dict.fromkeys(HEAD_FORMS,
                                                                0))


def _threefry_key(key):
    """`key` checked as keys ``[..., 2]`` of int64 words on a device the
    draws run on; returns its device.  (The host key chain checks 1,500
    keys a job: ~2 us each beside a split's ~1.2 ms on the CPU.)"""
    if key.dtype != torch.int64 or key.dim() == 0 or key.shape[-1] != 2:
        raise ValueError(f"threefry: the key must be int64 of shape "
                         f"[..., 2], got {key.dtype} {tuple(key.shape)}")
    device = key.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"threefry: unsupported device {device}")
    return device


def _draw(form, key, shape, out_shape, dtype, span=1, mult=0, minval=0,
          p=0.0):
    """Launch the `form` draw of `n` = prod(`shape`) elements a lane of
    the CUDA `key` into a new ``[*key.shape[:-1], *out_shape]`` tensor of
    `dtype`, on the current stream, and count it: `threefry.launches` and
    `threefry.launches_by_kernel[form]` on the host, its
    `device_launches` slot on the device."""
    if not _on_current_device(key.device):
        with torch.cuda.device(key.device):
            return _draw(form, key, shape, out_shape, dtype, span, mult,
                         minval, p)
    lanes = tuple(key.shape[:-1])
    n = math.prod(shape)
    total = math.prod(lanes) * n
    if total >= 2**31:
        raise ValueError(f"threefry: {total} elements exceed the kernel's "
                         f"32-bit element index")
    out = torch.empty(lanes + tuple(out_shape), dtype=dtype,
                      device=key.device)
    if total == 0:
        return out
    # one lane dimension: a view wherever the lanes' strides allow one
    flat = key.reshape(-1, 2)
    rc = _fn("netsim_threefry")(
        THREEFRY_FORMS.index(form), flat.data_ptr(), flat.stride(0),
        flat.stride(1), n, total, out.data_ptr(), span, mult,
        minval & 0xFFFFFFFF, p, _launch_slot(key.device, "threefry", form),
        _stream())
    if rc != 0:
        raise RuntimeError(f"netsim threefry {form} kernel launch failed: "
                           f"CUDA error {rc}")
    threefry.launches += 1
    threefry.launches_by_kernel[form] += 1
    return out


def _shape(shape) -> tuple:
    return tuple(int(s) for s in shape)


def threefry_split(key, num: int = 2):
    """`jax.random.split(key, num)`: the same arguments and result as
    `ref.threefry_split_ref` (keys ``[..., 2]`` -> ``[..., num, 2]``,
    int64)."""
    if _threefry_key(key).type == "cpu":
        return threefry_split_ref(key, num)
    return _draw("split", key, (int(num),), (int(num), 2), torch.int64)


def threefry_bits(key, shape):
    """32 random bits an element (uint32 values in int64): the same
    arguments and result as `ref.threefry_bits_ref`."""
    if _threefry_key(key).type == "cpu":
        return threefry_bits_ref(key, shape)
    shape = _shape(shape)
    return _draw("bits", key, shape, shape, torch.int64)


def threefry_uniform(key, shape):
    """`jax.random.uniform(key, shape)` (float32 in [0, 1)): the same
    arguments and result as `ref.threefry_uniform_ref`."""
    if _threefry_key(key).type == "cpu":
        return threefry_uniform_ref(key, shape)
    shape = _shape(shape)
    return _draw("uniform", key, shape, shape, torch.float32)


def threefry_randint(key, shape, minval: int, maxval: int):
    """`jax.random.randint(key, shape, minval, maxval)` (int32): the same
    arguments and result as `ref.threefry_randint_ref`; bounds outside
    int32 raise ValueError on every device."""
    if _threefry_key(key).type == "cpu":
        return threefry_randint_ref(key, shape, minval, maxval)
    span, mult = randint_span(minval, maxval)
    shape = _shape(shape)
    return _draw("randint", key, shape, shape, torch.int32, span=span,
                 mult=mult, minval=int(minval))


def threefry_bernoulli(key, p: float, shape):
    """`jax.random.bernoulli(key, p, shape)` (bool; `p` rounded to
    float32, the threshold): the same arguments and result as
    `ref.threefry_bernoulli_ref`."""
    if _threefry_key(key).type == "cpu":
        return threefry_bernoulli_ref(key, p, shape)
    shape = _shape(shape)
    return _draw("bernoulli", key, shape, shape, torch.bool, p=float(p))


# the host counts of the draws, by form, under the wrapper name that
# `WRAPPERS` and `device_launches` give them
threefry = SimpleNamespace(launches=0,
                           launches_by_kernel=dict.fromkeys(THREEFRY_FORMS,
                                                            0))
