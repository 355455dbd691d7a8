"""The share of the window outside the sweep's own clock: 1 - the jobs'
summed `wall_s` and `compile_s` (the runner's clocks of each grid's run
and capture) over the window, in %.  Lowering the spec, planning the
lanes, allocating their state and `finalize` run there, the card idle."""


def read(ctx):
    inside = sum(job.wall_s + job.compile_s for job in ctx.jobs)
    return 100.0 * (1.0 - inside / ctx.window_s)
