"""The comparison that decides a run's `correct`: the program's per-lane
`SimResult`s against the reference's, lane for lane.

The simulator is integer-exact (ROADMAP: "Simulator: bit-for-bit"), so
both numbers compared have the limit 0: `lanes_differing`, the sampled
lanes with any field unequal, and `widest_counter_gap`, the widest
absolute gap over a lane's counters (delivered, generated, dropped,
stranded, reaped, occupancy peak, hops by channel type, and the latency
sum).
"""
from __future__ import annotations

LIMITS = {"lanes_differing": 0, "widest_counter_gap": 0}


def counters(res) -> dict:
    """A result's integer counters and its latency sum."""
    out = dict(delivered=res.delivered_pkts, generated=res.generated_pkts,
               dropped=res.dropped_pkts, stranded=res.stranded_pkts,
               reaped=res.reaped_pkts, occupancy_peak=res.occupancy_peak,
               lat_sum=res.avg_latency * max(res.delivered_pkts, 1))
    out.update({f"hops.{k}": v for k, v in res.hops_by_type.items()})
    return out


def compare(got: list, want: list) -> dict:
    """The numbers compared, each beside its limit."""
    if len(got) != len(want):
        raise ValueError(f"{len(got)} program lanes against {len(want)} "
                         f"reference lanes")
    differing, gap = 0, 0.0
    for g, w in zip(got, want):
        differing += vars(g) != vars(w)
        cg, cw = counters(g), counters(w)
        if cg.keys() != cw.keys():
            differing += 1
            continue
        gap = max([gap] + [abs(cg[k] - cw[k]) for k in cg])
    return {"lanes_differing": {"value": differing,
                                "limit": LIMITS["lanes_differing"]},
            "widest_counter_gap": {"value": gap,
                                   "limit": LIMITS["widest_counter_gap"]}}


def passes(checked: dict) -> bool:
    return all(v["value"] <= v["limit"] for v in checked.values())
