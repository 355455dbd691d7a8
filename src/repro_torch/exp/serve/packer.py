"""Device-filling packs: heterogeneous lanes -> one windowed session (port
of `repro.exp.serve.packer`).

A `Pack` wraps one `LaneSession` over up to `pack` lane units from ANY
mix of requests/tenants that share a bucket signature.  Every pack of a
bucket replays the SAME CUDA graphs:

  * `pad_to=pack` ghost-pads short packs to the fixed batch size
    (rate-0 lanes whose stats are never read back);
  * `force_stack=True` keeps the per-lane fault axis stacked even when
    the packed lanes happen to share one fault set;
  * `epochs=bucket.epochs` pins warm buckets to a fixed epoch-stacked
    lane form.

Lanes never mix, so a lane's counters are bit for bit the same whichever
other tenants' lanes share its pack.
"""
from __future__ import annotations

from ...core.engine.stats import lane_stats
from .scheduler import BucketKey, bucket_sweep


class Pack:
    """One active windowed dispatch of `units` (real lanes, in order)."""

    __slots__ = ("sid", "bucket", "units", "sweep", "session", "chips",
                 "prev_cycle", "device")

    def __init__(self, sid: int, bucket: BucketKey, units: list,
                 session, sweep, device=None):
        self.sid = sid
        self.bucket = bucket
        self.units = units
        self.sweep = sweep
        self.session = session
        self.device = device
        # accepted-throughput divisor per real lane (mask AND alive)
        self.chips = [sweep._chips(f)
                      for f in session.fault_sets[:len(units)]]
        self.prev_cycle = session.cycle

    @classmethod
    def open(cls, sid: int, bucket: BucketKey, units: list, *,
             window: int, pack: int, restore: dict | None = None,
             device=None) -> "Pack":
        """Open the pack's session on `device` (the bucket's sweep on that
        device)."""
        sweep = bucket_sweep(bucket, device)
        session = sweep.start_lanes(
            [u.triple() for u in units], window=window,
            pad_to=max(pack, len(units)), force_stack=True,
            epochs=bucket.epochs or None, restore=restore)
        return cls(sid, bucket, units, session, sweep, sweep.device)

    @property
    def done(self) -> bool:
        return self.session.done()

    def advance(self) -> tuple[int, int]:
        """One window; returns the (start, end) cycle range covered."""
        self.prev_cycle = self.session.cycle
        return self.prev_cycle, self.session.advance()

    def lane_stats(self):
        """(unit, host-SimStats) pairs for the real lanes — the window-
        record source."""
        stats = self.session.stats_host()
        return [(u, lane_stats(stats, i)) for i, u in enumerate(self.units)]

    def finish(self):
        """(unit, SimResult) pairs once the budget is exhausted."""
        run = self.session.finish()
        return list(zip(self.units, run.results))

    def export(self) -> dict:
        return self.session.export()
