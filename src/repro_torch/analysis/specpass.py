"""Spec pass: static verification of experiment specs, no simulation
(port of `repro.analysis.specpass`, the same rules, memo key and proof
RNG).

For every scenario (registered name or `--spec FILE` JSON) the pass
establishes, per (topology x routing) cell family:

  SPEC_INVALID   the spec doesn't construct: `ExperimentSpec.from_dict`
                 rejected it, or the file does not read as JSON.
                 Registered scenarios can't hit this — construction
                 already ran at import — so it fires for file-loaded
                 specs.
  SPEC_VC        the VC scheme resolves (`routing.num_vcs`) — info with
                 the resolved VC count per class.
  SPEC_CDG       a channel-dependency-graph deadlock proof failed: the
                 pristine net, a sampled cold fault set, or some epoch
                 of a warm `FaultSchedule` traced a CDG cycle or crossed
                 a dead channel (`routing.verify.assert_deadlock_free`).
  SPEC_FAULTS    the fault population can't be sampled routably.
  SPEC_REPAIR    info: the schedule contains repair (shrinking) epochs;
                 every such transition was also proven restart-safe for
                 packets in flight (`verify.assert_transition_safe`).
  SPEC_GRANT / SPEC_GRANT_OVERFLOW
                 the grant form a `fused`/`compact` cell takes in the
                 reference (`fused.grant_form`): the combined packed key,
                 or — a warning — the two-pass fallback when the packed
                 key would overflow int32.  The port's kernels serve both
                 with one 64-bit key, so the warning marks a spec whose
                 reference run would silently lose its fused grant.

The proofs run on the caller's device (`device=`, the CLI's `--device`):
the hop walk drives the port's route kernels there.  They are memoized
by network identity `(kind, params)` plus the VC scheme, the fault
population and the proof parameters — the reference's key — with one
memo a device, so the `--all` run proves each distinct combination once.
The flows come from `np.random.default_rng(0)`, as in the reference, so
the edge counts equal the reference's.
"""
from __future__ import annotations

import json

import numpy as np

from ..core.engine.fused import grant_form
from ..core.routing import num_vcs
from ..core.routing.verify import (assert_deadlock_free,
                                   assert_schedule_deadlock_free)
from ..core.topology import FaultSchedule
from ..device import resolve_device
from ..exp.registry import get_scenario
from ..exp.spec import ExperimentSpec

PASS = "spec"

# device -> {proof key: (edges, epochs, repairs)} (successes only;
# failures re-raise)
_PROOF_CACHE: dict = {}

DEFAULT_PAIRS = 400
DEFAULT_EXHAUSTIVE = 20_000


def _fault_key(f) -> tuple:
    return (f.kind, f.frac, f.num, f.num_clusters, f.radius, f.types,
            f.seed, f.per_seed, f.onsets, f.repairs)


def _prove(net, topo, vc_mode, nonminimal, fault_spec, lane_seed,
           n_pairs, exhaustive_limit, device) -> tuple:
    """One memoized deadlock proof; returns (edges, epochs, repairs,
    cached).  `repairs` counts the schedule's shrinking (repair)
    transitions, each also proven restart-safe for in-flight packets."""
    key = (topo.kind, topo.params, vc_mode, nonminimal,
           None if fault_spec is None else _fault_key(fault_spec),
           None if fault_spec is None else lane_seed,
           n_pairs, exhaustive_limit)
    memo = _PROOF_CACHE.setdefault(str(device), {})
    if key in memo:
        return memo[key] + (True,)
    rng = np.random.default_rng(0)
    repairs = 0
    if fault_spec is None:
        edges = assert_deadlock_free(
            net, vc_mode, nonminimal, rng, n_pairs=n_pairs,
            exhaustive_limit=exhaustive_limit, device=device)
        epochs = 1
    else:
        sampled = fault_spec.sample(net, vc_mode, lane_seed)
        if isinstance(sampled, FaultSchedule):
            per_epoch = assert_schedule_deadlock_free(
                net, vc_mode, nonminimal, rng, sampled, n_pairs=n_pairs,
                device=device)
            edges, epochs = sum(per_epoch), len(per_epoch)
            repairs = sum(
                1 for i in range(1, sampled.num_epochs)
                if not sampled.repaired_at(i).is_empty)
        else:
            edges = assert_deadlock_free(
                net, vc_mode, nonminimal, rng, n_pairs=n_pairs,
                exhaustive_limit=exhaustive_limit, faults=sampled,
                device=device)
            epochs = 1
    memo[key] = (edges, epochs, repairs)
    return edges, epochs, repairs, False


def check_spec(spec: ExperimentSpec, origin: str, report, *,
               n_pairs: int = DEFAULT_PAIRS,
               exhaustive_limit: int = DEFAULT_EXHAUSTIVE,
               device=None) -> None:
    """Run every spec-pass check on one constructed spec, the proofs on
    `device`."""
    device = resolve_device(device)
    faulty = [f for f in spec.axes.faults if not f.is_none]
    lane_seed = spec.axes.seeds[0]
    for topo in spec.topologies:
        for routing in spec.routings:
            where = f"{origin} [{topo.label} x {routing.label}]"
            nonmin = routing.route_mode != "min"
            try:
                nv = num_vcs(topo.kind, routing.vc_mode, nonmin)
            except (KeyError, ValueError) as e:
                report.add(PASS, "SPEC_VC", "error", where,
                           f"VC scheme does not resolve: {e}")
                continue
            report.add(
                PASS, "SPEC_VC", "info", where,
                f"{nv} VC classes x {routing.vcs_per_class} per class")

            net = topo.build()
            proofs, edges, cached, repairs = 0, 0, 0, 0
            try:
                e, _, _, hit = _prove(net, topo, routing.vc_mode, nonmin,
                                      None, lane_seed, n_pairs,
                                      exhaustive_limit, device)
                proofs, edges, cached = 1, e, int(hit)
                for f in faulty:
                    e, epochs, reps, hit = _prove(
                        net, topo, routing.vc_mode, nonmin, f, lane_seed,
                        n_pairs, exhaustive_limit, device)
                    proofs += epochs
                    edges += e
                    repairs += reps
                    cached += int(hit)
            except AssertionError as e:
                report.add(PASS, "SPEC_CDG", "error", where,
                           f"deadlock proof failed: {e}")
                continue
            except ValueError as e:
                report.add(PASS, "SPEC_FAULTS", "error", where,
                           f"fault population unroutable: {e}")
                continue
            report.add(
                PASS, "SPEC_CDG", "info", where,
                f"{proofs} epoch CDG(s) acyclic ({edges} dependency "
                f"edges, {cached} proof(s) shared with earlier "
                f"scenarios; proven on {device.type})")
            if repairs:
                report.add(
                    PASS, "SPEC_REPAIR", "info", where,
                    f"{repairs} repair (shrinking) transition(s) proven "
                    f"restart-safe for in-flight packets on the "
                    f"recovered subgraph")

            if routing.step_impl in ("fused", "compact"):
                cfg = routing.to_simconfig(spec.axes)
                form = grant_form(net, cfg)
                impl = routing.step_impl
                if form == "combined":
                    report.add(PASS, "SPEC_GRANT", "info", where,
                               f"{impl} step takes the combined "
                               "single-segment_min grant")
                else:
                    cycles = spec.axes.warmup + spec.axes.measure
                    report.add(
                        PASS, "SPEC_GRANT_OVERFLOW", "warning", where,
                        f"{impl} step falls back to the two-pass grant in "
                        f"the reference: the packed cycle<<log2(N)|key "
                        f"arbitration key overflows int32 at {cycles} "
                        f"cycles on this net (the port's 64-bit key is "
                        f"exact either way; shrink warmup+measure or "
                        f"accept with an allowlist entry)")


def check_scenario(name: str, report, **kw) -> None:
    check_spec(get_scenario(name), f"scenario:{name}", report, **kw)


def load_spec_file(path: str, report, pass_name: str = PASS):
    """The `ExperimentSpec` a JSON file holds, or None after adding a
    SPEC_INVALID error (the file does not read, or does not
    construct)."""
    try:
        with open(path) as f:
            d = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        report.add(pass_name, "SPEC_INVALID", "error", path,
                   f"unreadable spec file: {e}")
        return None
    try:
        return ExperimentSpec.from_dict(d)
    except (ValueError, KeyError, TypeError) as e:
        report.add(pass_name, "SPEC_INVALID", "error", path,
                   f"spec does not construct: {e}")
        return None


def check_spec_file(path: str, report, **kw) -> None:
    """Spec-pass a JSON spec file — the admission test for external
    specs: construction errors land as SPEC_INVALID instead of raising."""
    spec = load_spec_file(path, report)
    if spec is not None:
        check_spec(spec, f"spec:{path}", report, **kw)
