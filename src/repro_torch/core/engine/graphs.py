"""The cycle loop as captured CUDA graphs: the port's counterpart of the
reference's AOT executable cache (`repro.core.engine.sweep`, `_AOT_CACHE`
and `compile_counter`).

A `CycleGraph` holds K cycles of one step (`step.superstep_body`) over
static buffers: the lanes' state, their rates and fault data, the cycle
index `t`, the warmup cycle and the K subkeys of one superstep.  The
graph writes its new state back into the static state and advances `t`
by K at its end, so a run of `cycles` cycles is one load of the static
inputs and ``cycles / K`` replays, each after one device copy of the
superstep's subkeys out of the run's key chain (`step.key_chain`,
drawn on the first chunk's device).  On a CUDA device the superstep is
captured and replayed; on the CPU the same superstep runs eagerly on the
same buffers.

A sweep's one runner (`sweep._advance`) uses them two ways.  A windowed
`sweep.LaneSession` copies its state into the static buffers, sets `t` to
its absolute cycle (the warmup reset stays absolute), replays, and copies
the state back out (`CycleGraph.advance`), so sessions of one signature
interleave on one graph; a one-shot run is one window of the whole budget
that copies only the counters out (`CycleGraph.run`).

`graph_for` keeps one graph for each (step, K, lane count, lane-data
signature, device) key, the last `GRAPHS_KEPT` keys used (each graph
holds its static state and memory pool, hundreds of MB at the paper's
scale), and on CUDA captures on a miss: a warm-up of one
superstep on the capture stream (it builds the kernels and creates every
tensor a step makes lazily, such as the coop kernel's scratch, outside
the graph), then the capture.  A capture that fails raises; nothing
falls back to the eager loop.  `captures()` counts the captures,
`builds()` the graphs made on any device (a capture on CUDA, a set of
static buffers on the CPU), and `clear()` drops the graphs with their
memory pools.  A caller that cycles through more than `GRAPHS_KEPT`
keys (a service with more live signatures) evicts and recaptures.

The netsim wrappers' host counts tick where a wrapper launches: at the
warm-up and once for each launch the capture records, never at a
replay.  What the card ran, replays included, the kernels count on the
device (`netsim.ops.device_launches`).
"""
from __future__ import annotations

import time
from collections import OrderedDict

import torch

from ...kernels.netsim import ops as netsim_ops
from ...spans import span
from .state import SimState, SimStats, with_sink_row
from .step import superstep_body

# key -> CycleGraph, the least recently used first
_GRAPHS: OrderedDict = OrderedDict()
GRAPHS_KEPT = 8
_CAPTURES = [0]
_BUILDS = [0]
# device -> the side stream every capture (and its warm-up) runs on
_STREAMS: dict = {}


def captures() -> int:
    """Graphs captured so far in this process."""
    return _CAPTURES[0]


def builds() -> int:
    """Graphs made so far in this process, on any device (a cache miss of
    `graph_for`; on CUDA each is a capture)."""
    return _BUILDS[0]


def clear() -> None:
    """Drop every cached graph and its memory pool."""
    _GRAPHS.clear()


def lane_signature(fl: dict) -> tuple:
    """Hashable signature of a lane dict: each tensor's name, shape, dtype
    and whether it is shared over the lanes (a stride-0 view)."""
    return tuple((k, tuple(v.shape), v.dtype, v.dim() > 0
                  and v.stride(0) == 0) for k, v in sorted(fl.items()))


def _state_signature(state: SimState) -> tuple:
    return tuple((k, tuple(v.shape), v.dtype)
                 for k, v in _leaves(state).items())


def _leaves(state: SimState) -> dict:
    out = {k: v for k, v in vars(state).items() if k != "stats"}
    out.update({f"stats.{k}": v for k, v in vars(state.stats).items()})
    return out


def state_like(state: SimState) -> SimState:
    """Buffers shaped like `state`; `b_pkt` keeps its spare channel row."""
    fields = {k: torch.empty_like(v) for k, v in vars(state).items()
              if k not in ("stats", "b_pkt")}
    store = torch.empty_like(with_sink_row(state.b_pkt))
    fields["b_pkt"] = store.narrow(1, 0, state.b_pkt.shape[1])
    stats = SimStats(**{k: torch.empty_like(v)
                        for k, v in vars(state.stats).items()})
    return SimState(stats=stats, **fields)


def copy_state(dst: SimState, src: SimState) -> None:
    """`src` into the buffers of `dst`; a field the step updated in place
    (`b_pkt`, `s_pkt`) is the same tensor and is skipped."""
    d, s = _leaves(dst), _leaves(src)
    for k, v in s.items():
        if v is not d[k]:
            d[k].copy_(v)


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    stream = _STREAMS.get(device)
    if stream is None:
        stream = _STREAMS[device] = torch.cuda.Stream(device)
    return stream


class CycleGraph:
    """K cycles of `step` over static buffers shaped like the arguments
    (see the module docstring): captured on a CUDA device, run eagerly on
    the CPU."""

    def __init__(self, step, K: int, state0: SimState, rate_pkt, fl):
        self.K = K
        self._body = superstep_body(step, K)
        dev = rate_pkt.device
        self.state = state_like(state0)
        self.rate = torch.empty_like(rate_pkt)
        # shared lanes keep one [1, ...] buffer behind a stride-0 view
        self._fl_base = {k: torch.empty_like(v[:1] if v.stride(0) == 0
                                             else v)
                         for k, v in fl.items()}
        self.fl = {k: b.expand_as(fl[k]) for k, b in self._fl_base.items()}
        self.t = torch.zeros((), dtype=torch.int32, device=dev)
        self.reset_at = torch.zeros((), dtype=torch.int32, device=dev)
        B = rate_pkt.shape[0]
        self.subs = torch.zeros((K, B, 2), dtype=torch.int64, device=dev)
        self.graph = None
        self.capture_s = 0.0
        self._scratch = []
        if dev.type == "cuda":
            self._capture(state0, rate_pkt, fl)

    def load(self, state0: SimState, rate_pkt, fl, reset_at: int,
             t0: int = 0) -> None:
        """Copy a run's inputs into the static buffers; `t` to cycle
        `t0` (the span `graph.copy`)."""
        with span("graph.copy"):
            copy_state(self.state, state0)
            self.rate.copy_(rate_pkt)
            for k, base in self._fl_base.items():
                v = fl[k]
                base.copy_(v[:1] if v.stride(0) == 0 else v)
            self.t.fill_(t0)
            self.reset_at.fill_(reset_at)

    def _advance(self) -> None:
        state = self._body(self.state, self.t, self.subs, self.rate,
                           self.fl, self.reset_at)
        copy_state(self.state, state)
        self.t.add_(self.K)

    def _capture(self, state0, rate_pkt, fl) -> None:
        t0 = time.perf_counter()
        dev = rate_pkt.device
        stream = _capture_stream(dev)
        self.load(state0, rate_pkt, fl, -1)
        # warm-up on the capture stream: the lazily made tensors (the coop
        # kernel's scratch is kept per stream) exist before the capture
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            self._advance()
        torch.cuda.current_stream(dev).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            self._advance()
        # the coop kernel's scratch is baked into the graph: keep it alive
        # even after `netsim.ops` evicts it
        self._scratch = list(netsim_ops._SCRATCH.values())
        self.graph = graph
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0
        _CAPTURES[0] += 1

    def _replay(self, state0: SimState, rate_pkt, fl, reset_at: int,
                subs, t0: int) -> None:
        """Load the inputs and advance ``len(subs)`` cycles (`subs` the
        ``[cycles, B, 2]`` subkeys, a multiple of K) from cycle `t0`; the
        loop is the span `graph.replays`."""
        self.load(state0, rate_pkt, fl, reset_at, t0)
        K = self.K
        with span("graph.replays"):
            for r in range(subs.shape[0] // K):
                self.subs.copy_(subs[r * K:(r + 1) * K])
                if self.graph is None:
                    self._advance()
                else:
                    self.graph.replay()

    def run(self, state0: SimState, rate_pkt, fl, reset_at: int, subs,
            t0: int = 0) -> SimStats:
        """Advance the lanes ``len(subs)`` cycles from cycle `t0`; returns
        a copy of the final counters (and nothing of the state), so a
        later run may reuse the buffers."""
        self._replay(state0, rate_pkt, fl, reset_at, subs, t0)
        with span("graph.copy"):
            return SimStats(**{k: v.clone()
                               for k, v in vars(self.state.stats).items()})

    def advance(self, state: SimState, rate_pkt, fl, reset_at: int, subs,
                t0: int) -> None:
        """One window of a session: advance `state` ``len(subs)`` cycles
        from absolute cycle `t0` in place (copied in, replayed, copied
        back out)."""
        self._replay(state, rate_pkt, fl, reset_at, subs, t0)
        with span("graph.copy"):
            copy_state(state, self.state)


def graph_for(step, K: int, state0: SimState, rate_pkt, fl) -> tuple:
    """(the cached `CycleGraph` of this key, whether it was captured now:
    never on the CPU)."""
    key = (step, K, int(rate_pkt.shape[0]), _state_signature(state0),
           lane_signature(fl), rate_pkt.device)
    graph = _GRAPHS.get(key)
    if graph is not None:
        _GRAPHS.move_to_end(key)
        return graph, False
    graph = _GRAPHS[key] = CycleGraph(step, K, state0, rate_pkt, fl)
    _BUILDS[0] += 1
    while len(_GRAPHS) > GRAPHS_KEPT:
        _GRAPHS.popitem(last=False)
    return graph, graph.graph is not None
