"""Global hops a delivered packet: the sum of `hops_by_type["global"]`
over the sum of `delivered_pkts`, over every lane of every job of the
window (the program's own counters, which the check holds exact).
Under worst-case traffic it reads 1.0 when every packet routes
minimally and nears 2.0 when all go through an intermediate W-group, so
it shows how much of the cell's traffic UGAL sends non-minimally."""


def read(ctx):
    hops = delivered = 0
    for job in ctx.jobs:
        for row in job.results:
            for res in row:
                hops += res.hops_by_type["global"]
                delivered += res.delivered_pkts
    return hops / delivered if delivered else None
