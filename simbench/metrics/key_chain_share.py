"""The host key chain's share of a job, in %: the seconds of the
program's span `sweep.key_chain` (`repro_torch.spans`: the per-cycle
subkeys drawn on the host before the replays) over the job's wall time
on the host clock.  The job is the window's last, run once more through
the same entry after the traced segment (`run_experiment`, the same
lanes, the runner's cached sweep and graph), because the harness reads
no span around the window itself.  None without a card (on the CPU the
chain and the step share the processor, so the share is not the card's
wait) and where the program has no spans."""
import time
from importlib.util import find_spec

CHAIN = "sweep.key_chain"


def read(ctx):
    if ctx.device.type != "cuda" or not find_spec("repro_torch.spans"):
        return None
    chain_s, wall_s = rerun_last_job(ctx)
    return 100.0 * chain_s / wall_s


def rerun_last_job(ctx) -> tuple:
    """(key-chain seconds, wall seconds) of the window's last job run
    again."""
    from repro_torch import spans
    from repro_torch.exp.runner import run_experiment
    from simbench.harness import _log, job_spec
    job = ctx.jobs[-1]
    spec = job_spec(ctx.config, ctx.traffic, job.seeds, f"job{job.index}")
    before = spans.totals().get(CHAIN, (0, 0.0))[1]
    t0 = time.perf_counter()
    run_experiment(spec, device=ctx.device)
    wall_s = time.perf_counter() - t0
    chain_s = spans.totals().get(CHAIN, (0, 0.0))[1] - before
    _log(f"job {job.index} again: {wall_s} s, {CHAIN} {chain_s} s")
    return chain_s, wall_s
