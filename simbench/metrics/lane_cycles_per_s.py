"""Every lane-cycle of every job in the window over the window's wall
time (host clock; the window ends on the last job's counters on the
host)."""


def read(ctx):
    return ctx.lane_cycles / ctx.window_s
