"""Serve pass: statically certify the one-capture-per-bucket promise of
`repro_torch.exp.serve` (port of `repro.analysis.servepass`, the same
rule ids).

The service buckets every submitted lane by its signature key
(`scheduler.BucketKey`) and packs heterogeneous tenants' lanes into
ghost-padded, fixed-width windowed sessions, promising total captures ==
distinct buckets.  That promise fails in two ways this pass checks
without running a cycle:

  * a bucket's lanes don't stack into one lane dict — SERVE_ONE, error;
  * a pack's graph key depends on WHICH lanes landed in it (e.g. an
    epoch count the bucket key failed to capture), so two packs of one
    bucket would capture twice — SERVE_SIG, error.

The certification lowers a mixed submission exactly as the service does
(`scheduler.lower_request`), chunks each bucket's units FIFO into
pack-sized groups, and compares every pack's graph key — the one
`BatchedSweep.start_lanes` makes with `pad_to=pack`, `force_stack=True`
and `epochs=bucket.epochs` (`packer.Pack.open`), built on the `meta`
device from the lanes' real fault states — against the bucket's
CANONICAL key built from the key alone (empty fault proxies: fault
content never changes shapes, epoch count does, and `BucketKey.epochs`
pins it).  The step stands in the key as the bucket's sweep key (the
cell, its cycle budget), since `scheduler.bucket_sweep` keeps one step
for each.

  SERVE_BUCKET  info: the submission's census — lanes, buckets, distinct
                signatures, and the graphs the sessions make: a session
                advances K = `superstep(window)` cycles a replay and, when
                some window's length is not a multiple of K, makes a
                K = 1 graph for the tail too (`sweep.start_lanes`).  The
                window defaults as `SimService`'s does
                (`REPRO_SERVE_WINDOW`, 128).  The message says whether the
                graphs fit `graphs.GRAPHS_KEPT`: past it, sessions that
                interleave evict and recapture.

CLI: `python -m repro_torch.analysis.check --serve` runs the pass over
the registered smoke scenarios (`SMOKE_SUBMISSION`): a cold fault-free
grid, a cold multi-fault grid, and a warm-fault grid.
"""
from __future__ import annotations

import torch

from ..core.engine import graphs
from ..core.engine.state import build_lane, stack_lanes
from ..core.engine.sweep import superstep
from ..core.topology import FaultSchedule, FaultSet, as_fault_schedule
from ..exp.registry import get_scenario
from .compilepass import META, _sig_digest, graph_key_signature

PASS = "serve"

# the heterogeneous standing submission `--serve` certifies: one bucket
# each, three distinct signatures
SMOKE_SUBMISSION = ("smoke", "smoke_faults", "smoke_warm_faults")


def _canonical_fsets(key) -> list:
    """The bucket's key-derived lane proxy: shapes depend only on the
    epoch count (0 = cold), never on fault content."""
    if key.epochs:
        return [FaultSchedule(tuple((c, FaultSet())
                                    for c in range(key.epochs)))]
    return [FaultSet()]


def _sweep_identity(key) -> tuple:
    """What the bucket's step is made from (`scheduler.bucket_sweep`)."""
    return (key.topology, key.routing, key.traffic, key.warmup,
            key.measure)


def pack_key(key, fsets, pack: int, K: int = 1) -> tuple:
    """The graph key of one ghost-padded pack of bucket `key` holding
    lanes with fault states `fsets`, minus the step: the lane form
    `packer.Pack.open` asks `start_lanes` for (promote to schedules when
    the bucket is warm, stack with the epoch count pinned, replicate lane
    0's data into the ghost pad).  Raises on lane-structure mismatch (the
    SERVE_ONE failure)."""
    from ..exp.serve.scheduler import bucket_cfg

    net = key.topology.build()
    cfg = bucket_cfg(key)
    B = max(pack, len(fsets))
    if key.epochs or any(isinstance(f, FaultSchedule) for f in fsets):
        fsets = [as_fault_schedule(f) for f in fsets]
    memo: dict = {}
    for f in fsets:
        if f not in memo:
            memo[f] = build_lane(net, cfg, f, device=META)
    lane_data = stack_lanes([memo[f] for f in fsets],
                            epochs=key.epochs or None)
    pad = B - len(fsets)
    if pad:
        lane_data = {k: torch.cat([v, v[:1].expand((pad,) + v.shape[1:])])
                     for k, v in lane_data.items()}
    return graph_key_signature(net, cfg, B, lane_data, K)


def pack_signature(key, fsets, pack: int, K: int = 1) -> str:
    return _sig_digest(_sweep_identity(key), pack_key(key, fsets, pack, K))


def session_graphs(window: int, total: int) -> tuple:
    """The superstep factors of the graphs a session over `total` cycles
    at `window` makes: K = `superstep(window)`, and 1 for the tail when
    the last window's length is not a multiple of K."""
    K = superstep(window)
    tail = total % window % K
    return (K, 1) if K > 1 and tail else (K,)


def check_submission(names, report, pack: int = 8,
                     window: int | None = None) -> None:
    """Certify a mixed submission of registered scenarios lowers to
    exactly one graph signature per bucket at pack width `pack`, and count
    the graphs its sessions make at `window` (default: the service's)."""
    from ..exp.serve.scheduler import lower_request
    from ..exp.serve.service import serve_window

    window = serve_window() if window is None else int(window)
    origin = "serve:" + "+".join(names)
    by_bucket: dict = {}
    seq = 0
    for rid, name in enumerate(names, start=1):
        units, _ = lower_request(get_scenario(name), rid, "ci", seq)
        seq += len(units)
        for u in units:
            by_bucket.setdefault(u.bucket, []).append(u)

    ok = True
    sigs: set = set()
    made: set = set()
    for key, units in sorted(by_bucket.items(),
                             key=lambda kv: kv[1][0].seq):
        where = f"{origin} [{key.label}]"
        try:
            canon = pack_signature(key, _canonical_fsets(key), pack)
        except Exception as e:
            ok = False
            report.add(PASS, "SERVE_ONE", "error", where,
                       f"bucket's canonical lane form does not stack into "
                       f"one graph key: {type(e).__name__}: {e}")
            continue
        sigs.add(canon)
        for K in session_graphs(window, key.warmup + key.measure):
            made.add(pack_signature(key, _canonical_fsets(key), pack, K))
        for i in range(0, len(units), pack):
            chunk = units[i:i + pack]
            try:
                sig = pack_signature(key, [u.fset for u in chunk], pack)
            except Exception as e:
                ok = False
                report.add(
                    PASS, "SERVE_ONE", "error", where,
                    f"pack of lanes {[u.key for u in chunk]} does not "
                    f"stack into one graph key: {type(e).__name__}: {e}")
                continue
            if sig != canon:
                ok = False
                report.add(
                    PASS, "SERVE_SIG", "error", where,
                    f"pack of lanes {[u.key for u in chunk]} keys graph "
                    f"signature {sig} != the bucket's canonical {canon}: "
                    f"the bucket key does not capture everything the "
                    f"graph key depends on (a second capture per bucket "
                    f"at runtime)")
    if ok and by_bucket:
        n_units = sum(len(v) for v in by_bucket.values())
        fits = len(made) <= graphs.GRAPHS_KEPT
        report.add(
            PASS, "SERVE_BUCKET", "info", origin,
            f"{len(names)} spec(s), {n_units} lane(s), "
            f"{len(by_bucket)} bucket(s) -> {len(sigs)} capture "
            f"signature(s) at pack={pack}: every ghost-padded pack keys "
            f"its bucket's one canonical graph, so captures == distinct "
            f"buckets regardless of tenant interleaving; at window "
            f"{window} the sessions make {len(made)} graph(s), which "
            + ("fit" if fits else "exceed")
            + f" the {graphs.GRAPHS_KEPT} graphs.GRAPHS_KEPT keeps"
            + ("" if fits else " (sessions that interleave recapture)"))
