"""Shared JSONL record schema for incremental stat windows: port of
`repro.exp.windows`, byte for byte the reference's records (`dumps`,
`SCHEMA_VERSION`), so the two packages' streams diff line for line.

Both output paths of the experiment layer write the SAME records through
this module, so batch and serve artifacts are schema-identical and can
be diffed line-for-line:

  * `repro_torch.exp.serve` streams one `window` record per lane per
    advanced window (cumulative counters since the warmup reset) and one
    `result` record per finished lane;
  * `python -m repro_torch.exp.run --jsonl` emits each lane's FINAL window
    (the whole run as one window) plus the same `result` record.

Record kinds (every record carries `kind` + `schema`):

  meta     one header per artifact: source ("serve" | "run"), provenance
  request  one per accepted submission: request id, tenant, spec hash
  window   cumulative per-lane counters at a cycle boundary
  result   the lane's final `SimResult` fields
  done     one per completed request

Windowed throughput divides delivered flits by the MEASURED cycles so
far (`cycle_end - warmup`), which makes the final window's throughput
and latency exactly equal the `result` record's (`stats.finalize`
divides by `measure` — the same denominator once the budget is
exhausted).  Records carry no timestamps: a resumed service appends
byte-identical lines to the ones the uninterrupted run would have
written (pinned by `tests/test_torch_serve.py`).
"""
from __future__ import annotations

import json

SCHEMA_VERSION = 1


def lane_meta(*, scenario: str, tenant: str, request: int, cell: int,
              lane: int, topology: str, topo_kind: str, pattern: str,
              route_mode: str, vc_mode: str, fault: str, offered: float,
              seed: int) -> dict:
    """The identity block shared by a lane's window and result records."""
    return dict(scenario=scenario, tenant=tenant, request=request,
                cell=cell, lane=lane, topology=topology,
                topo_kind=topo_kind, pattern=pattern,
                route_mode=route_mode, vc_mode=vc_mode, fault=fault,
                offered=offered, seed=seed)


def meta_record(source: str, provenance: dict | None = None, **kw) -> dict:
    return dict(kind="meta", schema=SCHEMA_VERSION, source=source,
                provenance=provenance or {}, **kw)


def request_record(*, request: int, tenant: str, scenario: str,
                   spec_sha256: str, lanes: int) -> dict:
    return dict(kind="request", schema=SCHEMA_VERSION, request=request,
                tenant=tenant, scenario=scenario, spec_sha256=spec_sha256,
                lanes=lanes)


def done_record(*, request: int, tenant: str, scenario: str,
                lanes: int) -> dict:
    return dict(kind="done", schema=SCHEMA_VERSION, request=request,
                tenant=tenant, scenario=scenario, lanes=lanes)


def window_record(meta: dict, *, cycle_start: int, cycle_end: int,
                  warmup: int, pkt_len: int, chips: float, delivered: int,
                  generated: int, dropped: int, stranded: int,
                  lat_sum: float | None = None,
                  latency: float | None = None) -> dict:
    """One lane's cumulative counters at the `cycle_end` boundary.

    `latency` overrides the `lat_sum / delivered` average when the
    caller only has the already-averaged value (the batch path's
    `SimResult`); the two are the same number by construction.
    """
    measured = max(int(cycle_end) - int(warmup), 0)
    thr = delivered * pkt_len / max(measured, 1) / max(chips, 1e-9)
    if latency is None:
        latency = float(lat_sum) / max(delivered, 1)
    return dict(kind="window", schema=SCHEMA_VERSION, **meta,
                cycle_start=int(cycle_start), cycle_end=int(cycle_end),
                cycles_measured=measured, delivered_pkts=int(delivered),
                generated_pkts=int(generated), dropped_pkts=int(dropped),
                stranded_pkts=int(stranded), throughput=thr,
                latency=latency)


def window_from_stats(meta: dict, stats, *, cycle_start: int,
                      cycle_end: int, cfg, chips: float) -> dict:
    """The serve path: a window record from one lane's raw host
    `SimStats` counters (cumulative since the warmup reset)."""
    return window_record(
        meta, cycle_start=cycle_start, cycle_end=cycle_end,
        warmup=cfg.warmup, pkt_len=cfg.pkt_len, chips=chips,
        delivered=int(stats.delivered), generated=int(stats.generated),
        dropped=int(stats.dropped), stranded=int(stats.stranded),
        lat_sum=float(stats.lat_sum))


def window_from_result(meta: dict, result, *, warmup: int,
                       measure: int) -> dict:
    """The batch path: the run's final window, reconstructed from a
    `SimResult`.  Throughput recomputes through the same formula the
    serve path uses; with `cycle_end = warmup + measure` the denominator
    is `measure`, so the value equals `result.throughput_per_chip`
    exactly (both divide `delivered * pkt_len` by `measure * chips`)."""
    cycles = warmup + measure
    rec = window_record(
        meta, cycle_start=0, cycle_end=cycles, warmup=warmup,
        pkt_len=1, chips=1.0, delivered=result.delivered_pkts,
        generated=result.generated_pkts, dropped=result.dropped_pkts,
        stranded=result.stranded_pkts, latency=result.avg_latency)
    rec["throughput"] = result.throughput_per_chip  # verbatim, no re-div
    return rec


def result_record(meta: dict, result) -> dict:
    """One lane's final `SimResult` as a flat record."""
    return dict(kind="result", schema=SCHEMA_VERSION, **meta,
                throughput=result.throughput_per_chip,
                latency=result.avg_latency,
                delivered_pkts=result.delivered_pkts,
                generated_pkts=result.generated_pkts,
                dropped_pkts=result.dropped_pkts,
                stranded_pkts=result.stranded_pkts,
                hops_by_type=dict(result.hops_by_type),
                avg_hops_by_type=dict(result.avg_hops_by_type))


def dumps(rec: dict) -> str:
    """Canonical one-line form (sorted keys, no whitespace): identical
    records serialize to identical bytes, so resumed-vs-uninterrupted
    artifacts can be compared as text."""
    return json.dumps(rec, sort_keys=True, separators=(",", ":"))
