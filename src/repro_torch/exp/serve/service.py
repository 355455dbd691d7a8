"""`SimService`: the long-lived, multi-tenant simulation service loop
(port of `repro.exp.serve.service`).

In-process API:

    svc = SimService(out="serve.jsonl", state_dir="ckpt")   # on CUDA
    rid = svc.submit(get_scenario("smoke"), tenant="alice")
    svc.run()                       # drive to completion
    results = svc.results(rid)      # [cell][lane] of SimResult

One `run` round = (1) activate pending packs into window sessions
(tenant-fair, see `scheduler`), (2) advance every active session by one
window (round-robin), streaming a `window` record per real lane, (3)
finish exhausted sessions, streaming `result`/`done` records, (4)
checkpoint every `checkpoint_every` rounds.  Because the engine's
windowed sessions replay the one-shot PRNG chain exactly and pack
composition never enters a lane's math, per-lane results are
bit-identical to individual `run_experiment` calls, and the total
capture count equals the number of distinct signature buckets (while
they fit `graphs.GRAPHS_KEPT`; more live buckets evict and recapture).
The JSONL after its meta line is byte for byte the reference service's
for the same submissions, window and pack.

The service runs on one device (`device=None`: CUDA, or raise; tests pass
``device="cpu"``).

Checkpoint/resume: `checkpoint()` writes every active session's
exported state into ONE atomic snapshot (`repro_torch.checkpoint`, npz +
manifest, retention-K) with the full queue/bookkeeping as the manifest
`extra`; `SimService.resume(state_dir)` rebuilds the service — requests
re-lower deterministically, pending lanes re-queue in admission order,
active sessions restore bit-identically — so a killed service resumed
from its latest snapshot appends the exact records the uninterrupted
run would have written.

Knobs (both via `repro_torch.env_int`, flags/kwargs override):
`REPRO_SERVE_WINDOW` (cycles per window, default 128) and
`REPRO_SERVE_PACK` (lanes per pack, default 8).
"""
from __future__ import annotations

import sys
from dataclasses import dataclass, field

from ... import env_int
from ...checkpoint import Checkpointer, save_sim_state
from ...device import resolve_device
from ..provenance import provenance, spec_hash
from ..spec import ExperimentSpec
from .. import windows as W
from .packer import Pack
from .scheduler import Scheduler, bucket_cfg, lower_request


def serve_window() -> int:
    """`REPRO_SERVE_WINDOW` (default 128): cycles advanced per session
    per round — the streaming/checkpoint granularity.  A window runs only
    its real cycles on the bucket's graphs, so the choice never changes
    results (see `sweep.LaneSession` for the captures it costs)."""
    return max(1, env_int("REPRO_SERVE_WINDOW", 128))


def serve_pack() -> int:
    """`REPRO_SERVE_PACK` (default 8): lanes per packed dispatch.  Short
    packs ghost-pad up to this size so every pack of a bucket shares
    one graph; larger packs amortize launches, smaller ones reduce
    padding waste."""
    return max(1, env_int("REPRO_SERVE_PACK", 8))


def pack_device(sid: int):
    """Placement for pack `sid`: None, as the reference's on a
    single-device host — every pack runs on the service's device.  The
    reference's round-robin of packs over several devices is not
    ported."""
    return None


@dataclass
class _Request:
    rid: int
    tenant: str
    spec: ExperimentSpec
    units: list
    cells_meta: list
    done: set = field(default_factory=set)      # finished (cell, lane)
    results: dict = field(default_factory=dict)  # (cell, lane) -> SimResult

    @property
    def complete(self) -> bool:
        return len(self.done) == len(self.units)


class SimService:
    """A persistent queue of `ExperimentSpec`s over one warm engine."""

    def __init__(self, *, out=None, window: int | None = None,
                 pack: int | None = None, max_active: int | None = None,
                 state_dir: str | None = None, checkpoint_every: int = 0,
                 keep: int = 3, verbose: bool = False, device=None,
                 _resumed: bool = False):
        self.device = resolve_device(device)
        self.window = int(window) if window else serve_window()
        self.pack = int(pack) if pack else serve_pack()
        self.max_active = max_active
        self.state_dir = state_dir
        self.checkpoint_every = int(checkpoint_every)
        self.keep = int(keep)
        self.verbose = verbose
        self._sched = Scheduler(pack=self.pack)
        self._requests: dict[int, _Request] = {}
        self._active: dict[int, Pack] = {}
        self._seq = 0
        self._next_rid = 1
        self._next_sid = 1
        self._round = 0
        self.compile_s = 0.0
        self._out = None
        self._own_out = False
        if out is not None:
            if hasattr(out, "write"):
                self._out = out
            else:
                self._out = open(out, "a" if _resumed else "w")
                self._own_out = True
            if not _resumed:
                self._emit(W.meta_record("serve",
                                         provenance(device=self.device),
                                         window=self.window,
                                         pack=self.pack))

    # -- submission ---------------------------------------------------------

    def submit(self, spec: ExperimentSpec, tenant: str = "default") -> int:
        """Queue every lane of `spec`; returns the request id."""
        rid = self._next_rid
        self._next_rid += 1
        units, cells_meta = lower_request(spec, rid, tenant, self._seq)
        self._seq += len(units)
        req = _Request(rid, tenant, spec, units, cells_meta)
        self._requests[rid] = req
        self._sched.add(units)
        self._emit(W.request_record(
            request=rid, tenant=tenant, scenario=spec.name,
            spec_sha256=spec_hash(spec), lanes=len(units)))
        self._log(f"request {rid} ({tenant}): {spec.name}, "
                  f"{len(units)} lanes")
        return rid

    # -- the service loop ---------------------------------------------------

    @property
    def idle(self) -> bool:
        return not self._active and self._sched.pending == 0

    def step(self) -> bool:
        """One round: activate, advance every session one window, finish,
        checkpoint.  Returns True while work remains."""
        if self.idle:
            return False
        self._round += 1
        self._activate()
        for sid in sorted(self._active):
            pk = self._active[sid]
            start, end = pk.advance()
            cfg = bucket_cfg(pk.bucket)
            for i, (u, stats) in enumerate(pk.lane_stats()):
                self._emit(W.window_from_stats(
                    self._meta(u), stats, cycle_start=start,
                    cycle_end=end, cfg=cfg, chips=pk.chips[i]))
        for sid in [s for s, p in self._active.items() if p.done]:
            self._finish(self._active.pop(sid))
        if (self.state_dir and self.checkpoint_every
                and self._round % self.checkpoint_every == 0
                and not self.idle):
            self.checkpoint()
        return not self.idle

    def run(self, max_rounds: int | None = None) -> int:
        """Drive rounds until the queue drains (or `max_rounds`); always
        leaves a final snapshot when a `state_dir` is configured, so a
        `--max-rounds` kill is resumable from the exact stop point."""
        rounds = 0
        while (max_rounds is None or rounds < max_rounds) and self.step():
            rounds += 1
        if self.state_dir and not self.idle:
            self.checkpoint()
        return rounds

    def _activate(self) -> None:
        slots = (None if self.max_active is None
                 else self.max_active - len(self._active))
        tenant_active: dict = {}
        for pk in self._active.values():
            for t in {u.tenant for u in pk.units}:
                tenant_active[t] = tenant_active.get(t, 0) + 1
        for bucket, units in self._sched.take_packs(tenant_active, slots):
            sid = self._next_sid
            self._next_sid += 1
            pk = Pack.open(sid, bucket, units, window=self.window,
                           pack=self.pack, device=self.device)
            self.compile_s += pk.session.compile_s
            self._active[sid] = pk
            self._log(f"pack {sid}: {len(units)} lanes "
                      f"(+{pk.session.pad_fraction:.0%} ghost) "
                      f"[{bucket.label}]"
                      + f" @ {pk.device}"
                      + (f" captured in {pk.session.compile_s:.1f}s"
                         if pk.session.compile_count else ""))

    def _finish(self, pk: Pack) -> None:
        for u, res in pk.finish():
            req = self._requests[u.rid]
            req.results[(u.cell, u.lane)] = res
            req.done.add((u.cell, u.lane))
            self._emit(W.result_record(self._meta(u), res))
            if req.complete:
                self._emit(W.done_record(
                    request=req.rid, tenant=req.tenant,
                    scenario=req.spec.name, lanes=len(req.units)))
                self._log(f"request {req.rid} ({req.tenant}) done: "
                          f"{req.spec.name}")

    # -- results ------------------------------------------------------------

    def results(self, rid: int) -> list:
        """[cell][lane] of `SimResult` for a completed request (None for
        lanes finished before a resume snapshot — their records are in
        the JSONL stream of the earlier process)."""
        req = self._requests[rid]
        ncells = len(req.cells_meta)
        per_cell = [0] * ncells
        for u in req.units:
            per_cell[u.cell] = max(per_cell[u.cell], u.lane + 1)
        return [[req.results.get((ci, li))
                 for li in range(per_cell[ci])] for ci in range(ncells)]

    # -- checkpoint / resume ------------------------------------------------

    def checkpoint(self) -> str:
        """One atomic snapshot: every active session's state plus the
        complete queue bookkeeping (manifest `extra`), retention-K."""
        if not self.state_dir:
            raise ValueError("SimService has no state_dir")
        state = {f"s{sid}": pk.export()
                 for sid, pk in self._active.items()}
        extra = dict(
            version=1, round=self._round, seq=self._seq,
            next_rid=self._next_rid, next_sid=self._next_sid,
            window=self.window, pack=self.pack,
            max_active=self.max_active,
            checkpoint_every=self.checkpoint_every, keep=self.keep,
            requests=[dict(rid=r.rid, tenant=r.tenant,
                           spec=r.spec.to_dict(),
                           done=sorted(list(d) for d in r.done))
                      for r in self._requests.values()],
            active=[dict(sid=sid,
                         units=[list(u.key) for u in pk.units])
                    for sid, pk in sorted(self._active.items())],
            pending=self._sched.export())
        path = save_sim_state(self.state_dir, self._round, state,
                              extra=extra, keep=self.keep)
        self._log(f"checkpoint @ round {self._round} -> {path}")
        return path

    @classmethod
    def resume(cls, state_dir: str, *, out=None, verbose: bool = False,
               device=None) -> "SimService":
        """Rebuild a service from its latest snapshot.  Requests
        re-lower deterministically (same cell/lane order, same memoized
        fault sampling), pending lanes re-queue in admission order, and
        each active session restores its exact `SimState`/keys/cycle —
        the resumed run is bit-identical to the uninterrupted one."""
        ckpt = Checkpointer(state_dir)
        extra = ckpt.manifest().get("extra")
        if not extra:
            raise FileNotFoundError(
                f"no serve bookkeeping in the snapshots under {state_dir}")
        svc = cls(out=out, window=extra["window"], pack=extra["pack"],
                  max_active=extra["max_active"], state_dir=state_dir,
                  checkpoint_every=extra["checkpoint_every"],
                  keep=extra["keep"], verbose=verbose, device=device,
                  _resumed=True)
        svc._round = extra["round"]
        svc._seq = extra["seq"]
        svc._next_rid = extra["next_rid"]
        svc._next_sid = extra["next_sid"]
        unit_index: dict = {}
        for r in extra["requests"]:
            spec = ExperimentSpec.from_dict(r["spec"])
            units, cells_meta = lower_request(spec, r["rid"], r["tenant"],
                                              0)
            req = _Request(r["rid"], r["tenant"], spec, units, cells_meta)
            req.done = {tuple(d) for d in r["done"]}
            svc._requests[r["rid"]] = req
            for u in units:
                unit_index[u.key] = u
        for rid, cell, lane, seq in extra["pending"]:
            u = unit_index[(rid, cell, lane)]
            u.seq = seq
        svc._sched.add(
            sorted((unit_index[(rid, cell, lane)]
                    for rid, cell, lane, _ in extra["pending"]),
                   key=lambda u: u.seq))
        # restore active sessions: open fresh packs to get the snapshot
        # template (shapes/dtypes), pull the arrays back in, then reopen
        # each pack from its restored state (the second open hits the
        # same cached graph — no recapture)
        fresh = {}
        for row in extra["active"]:
            units = [unit_index[tuple(k)] for k in row["units"]]
            fresh[row["sid"]] = Pack.open(
                row["sid"], units[0].bucket, units,
                window=svc.window, pack=svc.pack, device=svc.device)
            svc.compile_s += fresh[row["sid"]].session.compile_s
        if fresh:
            template = {f"s{sid}": pk.export()
                        for sid, pk in fresh.items()}
            restored, _ = ckpt.restore(template)
            for sid, pk in fresh.items():
                snap = restored[f"s{sid}"]
                snap["cycle"] = int(snap["cycle"])
                svc._active[sid] = Pack.open(
                    sid, pk.bucket, pk.units, window=svc.window,
                    pack=svc.pack, restore=snap, device=svc.device)
        svc._log(f"resumed @ round {svc._round}: "
                 f"{len(svc._active)} sessions, "
                 f"{svc._sched.pending} pending lanes")
        return svc

    # -- plumbing -----------------------------------------------------------

    def _meta(self, u) -> dict:
        req = self._requests[u.rid]
        cm = req.cells_meta[u.cell]
        return W.lane_meta(scenario=req.spec.name, tenant=u.tenant,
                           request=u.rid, cell=u.cell, lane=u.lane,
                           fault=u.fault, offered=u.rate, seed=u.seed,
                           **cm)

    def _emit(self, rec: dict) -> None:
        if self._out is not None:
            self._out.write(W.dumps(rec) + "\n")
            self._out.flush()

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(f"[serve] {msg}", file=sys.stderr, flush=True)

    def close(self) -> None:
        if self._own_out and self._out is not None:
            self._out.close()
            self._out = None

    def __enter__(self) -> "SimService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
