"""Step pass: the port's counterpart of `repro.analysis.jaxprpass`.

The reference traces every step abstractly.  A traced value has no
counterpart in eager PyTorch, so this pass runs ONE superstep of each
step the way a captured CUDA graph replays it (`step.superstep_body`
with `t` and the warmup reset as 0-d int32 tensors, K = 1) on a small
network, on the caller's device, and audits what went in and what came
out.  It is the only pass that runs a cycle, as the reference's batch
probe runs its route kernels concretely.

The matrix is the reference's: {jnp, fused, compact} x {baseline, updown,
updown_merged} x {pristine, cold FaultSet, warm FaultSchedule} — 27 cells
on `TRACE_TOPO` with GLOBAL-only link faults (routable under every VC
mode).  On a CUDA device the `jnp` cells launch the `grant` kernel, the
`fused` cells the coop `cycle_core` kernel and the `compact` cells the
three-pass `cycle_core` kernel (`kernels.netsim.ops.kernel_for`), once
each, and every cell the PRNG's `threefry` kernel once for its subkey
chain (`chain`) and once a draw (three: `split`, `uniform`, `randint`).

  STEP_CARRY  the output state's fields (the stats' included) differ
              from the input's in name, shape or dtype.  A replay writes
              the step's output into the graph's static buffers with
              `copy_` (`graphs.copy_state`), which broadcasts a changed
              shape and casts a changed dtype without raising, so such a
              step corrupts every replay silently.
  STEP_DTYPE  a 64-bit dtype in a state or lane-dict field.  The engine
              is int32/float32 by contract (the reference's, where the
              packed arbitration key budgets for int32).  The PRNG
              subkeys are int64 by design and are not state.
  STEP_BATCH  a route kernel broke batch purity: routing packet i must
              not depend on packet j != i.  Probed concretely, full batch
              against one packet at a time, for the three VC modes'
              `routing.pipeline.make_pipeline` kernels on `TRACE_TOPO`
              and the Dragonfly's under "baseline".
  STEP_TRACE  info: the operations one superstep issues — the aten
              operations a `TorchDispatchMode` sees, plus one for each
              netsim kernel launch (a ctypes call the dispatcher does not
              see) — the counterpart of the reference's equation count.
              An error when the step does not run.

JAXPR_OOB has no counterpart: the port has no promise-in-bounds scatter.
A write the reference drops out of bounds goes to a spare sink row behind
the buffers instead (`state.make_state`, `state.with_sink_row`).
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .. import random as jr
from ..core.engine import graphs
from ..core.engine.state import build_lane, make_state
from ..core.engine.step import key_chain, make_step, superstep_body
from ..core.routing import share_lanes
from ..core.routing.pipeline import make_pipeline
from ..core.simulator import SimConfig
from ..device import resolve_device
from ..exp.spec import FaultSpec, TopologySpec, TrafficSpec
from ..kernels.netsim import ops as netsim_ops

PASS = "step"

STEP_IMPLS = ("jnp", "fused", "compact")
VC_MODES = ("baseline", "updown", "updown_merged")
FAULT_KINDS = ("pristine", "cold", "warm")

# the trace network: small enough to run in milliseconds, big enough to
# exercise every channel class (mesh, local, global, inject, eject)
TRACE_TOPO = TopologySpec.switchless(a=2, b=2, m=2, n=4, noc=2, g=3)
LANES = 2
RATE_PKT = 0.25         # packets a terminal a cycle
WARMUP, MEASURE = 4, 12
# a cell's whole run: long enough that the arbitration sees contention
# (~1,200 hops a lane), for holding one device's cell against another's
CELL_CYCLES = WARMUP + MEASURE

_WIDE = {torch.int64, torch.float64, torch.complex128}
if hasattr(torch, "uint64"):
    _WIDE.add(torch.uint64)


def _fault_for(kind: str) -> FaultSpec | None:
    # GLOBAL-only link faults: routable under every VC mode, so the same
    # fault population serves the whole matrix
    if kind == "pristine":
        return None
    onsets = (4,) if kind == "warm" else ()
    return FaultSpec(kind="links", frac=0.2, types=("global",),
                     onsets=onsets)


class _OpCounter(TorchDispatchMode):
    """Counts the aten operations issued under it."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        return func(*args, **(kwargs or {}))


def _fields(state) -> dict:
    """field name -> (shape, dtype) of a `SimState`, stats included."""
    return {k: (tuple(v.shape), v.dtype)
            for k, v in graphs._leaves(state).items()}


def _launches() -> dict:
    return {w: getattr(netsim_ops, w).launches for w in netsim_ops.WRAPPERS}


def run_cell(step_impl: str, vc_mode: str, fault_kind: str, device,
             wrap=None, cycles: int = 1) -> dict:
    """One superstep of `cycles` cycles (the pass: 1) of a matrix cell on
    `device`; returns the output state, the fields in and out, the lane
    dict's dtypes, the aten operations issued and the netsim launches by
    wrapper.  `wrap(step) -> step` replaces the step (for fixture tests).
    Raises whatever the step raises."""
    net = TRACE_TOPO.build()
    cfg = SimConfig(warmup=WARMUP, measure=MEASURE, vc_mode=vc_mode,
                    route_mode="min", vcs_per_class=1, step_impl=step_impl)
    pattern = TrafficSpec("uniform").resolve(net)
    step, consts = make_step(net, cfg, pattern, device=device)
    if wrap is not None:
        step = wrap(step)
    fs = _fault_for(fault_kind)
    faults = None if fs is None else fs.sample(net, vc_mode, 0)
    fl = share_lanes(build_lane(net, cfg, faults, device=device), LANES)
    state = make_state(net, cfg, consts["NV"], batch=(LANES,),
                       device=device)
    keys = torch.stack([jr.PRNGKey(s) for s in range(LANES)])
    subs = key_chain(keys.to(device), cycles)[1]
    rate = torch.full((LANES,), RATE_PKT, dtype=torch.float32,
                      device=device)
    t0 = torch.zeros((), dtype=torch.int32, device=device)
    reset_at = torch.full((), cfg.warmup, dtype=torch.int32, device=device)
    body = superstep_body(step, cycles)
    fields_in = _fields(state)
    before = _launches()
    with _OpCounter() as counter:
        out = body(state, t0, subs, rate, fl, reset_at)
    after = _launches()
    return dict(out=out, fields_in=fields_in, fields_out=_fields(out),
                lane={k: v.dtype for k, v in fl.items()},
                ops=counter.ops,
                launches={w: after[w] - before[w] for w in after})


def check_cell(report, step_impl: str, vc_mode: str, fault_kind: str, *,
               device=None, wrap=None) -> dict | None:
    """Run and audit one matrix cell; returns its `run_cell` record (None
    when it does not run)."""
    device = resolve_device(device)
    where = f"step:{step_impl}/{vc_mode}/{fault_kind}"
    try:
        rec = run_cell(step_impl, vc_mode, fault_kind, device, wrap)
    except Exception as e:  # a cell that doesn't run is itself a bug
        report.add(PASS, "STEP_TRACE", "error", where,
                   f"step does not run: {type(e).__name__}: {e}")
        return None
    fin, fout = rec["fields_in"], rec["fields_out"]
    dtypes = ([(k, v[1]) for k, v in (*fin.items(), *fout.items())]
              + [(f"fl.{k}", dt) for k, dt in rec["lane"].items()])
    wide = sorted({f"{k}:{str(dt).replace('torch.', '')}"
                   for k, dt in dtypes if dt in _WIDE})
    if wide:
        report.add(PASS, "STEP_DTYPE", "error", where,
                   f"64-bit fields ({', '.join(wide)}): the engine is "
                   f"int32/float32 by contract")
    changed = sorted(k for k in set(fin) | set(fout)
                     if fin.get(k) != fout.get(k))
    if changed:
        report.add(PASS, "STEP_CARRY", "error", where,
                   f"output state fields differ from the input's in name, "
                   f"shape or dtype ({', '.join(changed)}): a graph replay "
                   f"copies them into the static buffers with copy_, which "
                   f"broadcasts or casts without raising")
    n_aten = rec["ops"]
    n_kern = sum(rec["launches"].values())
    if not (wide or changed):
        report.add(PASS, "STEP_TRACE", "info", where,
                   f"{n_aten + n_kern} operations in one superstep on "
                   f"{device.type} ({n_aten} aten, {n_kern} netsim kernel "
                   f"launch(es) counted one each); carry stable, no 64-bit "
                   f"fields")
    return rec


def probe_batch_purity(route_call, fl, cur, dest, mis, meta) -> list:
    """Compare full-batch routing of the ``[1, B]`` rows against one-packet
    slices; returns the indices where any output differs (empty ==
    pure).  `route_call(fl, cur, dest, mis, meta) -> (out_ch, req_vc,
    meta')`."""
    full = route_call(fl, cur, dest, mis, meta)
    bad = []
    for i in range(cur.shape[1]):
        s = slice(i, i + 1)
        row = route_call(fl, cur[:, s], dest[:, s], mis[:, s], meta[:, s])
        if any(not torch.equal(f[:, s], r) for f, r in zip(full, row)):
            bad.append(i)
    return bad


def check_kernel_batch_purity(report, net, vc_mode: str, *, device=None,
                              kernel=None, B: int = 48) -> None:
    """STEP_BATCH probe for one net's route kernel (or an injected
    `kernel`, for fixture tests)."""
    device = resolve_device(device)
    where = f"kernel:{net.meta['kind']}/{vc_mode}"
    pipe = make_pipeline(net, vc_mode, device=device)
    route_call = kernel if kernel is not None else pipe.kernel
    fl = share_lanes(pipe.tables(None), 1)
    rng = np.random.default_rng(7)
    term_node = np.asarray(net.term_node)
    row = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32,
                                    device=device)[None]
    cur = row(term_node[rng.integers(0, net.num_terminals, B)])
    dest = row(rng.integers(0, net.num_terminals, B))
    mis = torch.full((1, B), -1, dtype=torch.int32, device=device)
    meta = torch.zeros((1, B), dtype=torch.int32, device=device)
    bad = probe_batch_purity(route_call, fl, cur, dest, mis, meta)
    if bad:
        report.add(PASS, "STEP_BATCH", "error", where,
                   f"route kernel is not batch-pure: packets "
                   f"{bad[:6]} route differently alone vs in a batch "
                   f"of {B} — the engine would route them wrong")
    else:
        report.add(PASS, "STEP_BATCH", "info", where,
                   f"batch-pure over {B} probe packets")


def run_steppass(report, device=None) -> dict:
    """The whole matrix and the batch probes on `device`; returns
    {cell location: its `run_cell` record} for the cells that ran."""
    device = resolve_device(device)
    records = {}
    for step_impl in STEP_IMPLS:
        for vc_mode in VC_MODES:
            for fault_kind in FAULT_KINDS:
                rec = check_cell(report, step_impl, vc_mode, fault_kind,
                                 device=device)
                if rec is not None:
                    records[f"step:{step_impl}/{vc_mode}/{fault_kind}"] = rec
    net = TRACE_TOPO.build()
    for vc_mode in VC_MODES:
        check_kernel_batch_purity(report, net, vc_mode, device=device)
    dfly = TopologySpec.dragonfly(t=2, l=2, gl=2).build()
    check_kernel_batch_purity(report, dfly, "baseline", device=device)
    return records
