"""Fault tolerance: failure injection, checkpoint/restart, elastic
re-meshing, straggler detection.

The container has no real multi-host runtime, so node failures are
*simulated* (a configurable injector raises during the step loop) — but
the recovery code path is the real one a launcher would take: abandon the
step, rebuild the mesh over the surviving devices, restore the newest
snapshot (resharding onto the new mesh), fast-forward the data stream and
resume.  Straggler mitigation monitors per-step wall time against a
robust EMA and records mitigation actions (on a real cluster: re-dispatch
to a hot spare / exclude from the next allocation).

Port of `repro.runtime.fault_tolerance` (host code, copied); on one
device the re-mesh hook has nothing to rebuild."""
from __future__ import annotations

from dataclasses import dataclass, field

from .trainer import Trainer


class SimulatedNodeFailure(RuntimeError):
    pass


@dataclass
class FailureInjector:
    """Raises SimulatedNodeFailure at the configured global steps."""
    fail_at: tuple = ()
    fired: set = field(default_factory=set)

    def check(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise SimulatedNodeFailure(f"injected node failure at {step}")


@dataclass
class StragglerMonitor:
    """Flags steps slower than factor x the EMA and logs the mitigation the
    production launcher would take."""
    factor: float = 3.0
    alpha: float = 0.2
    ema: float | None = None
    events: list = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        is_straggler = self.ema is not None and dt > self.factor * self.ema
        if is_straggler:
            self.events.append(
                {"step": step, "dt": dt, "ema": self.ema,
                 "action": "redispatch-to-backup"})
        else:
            self.ema = dt if self.ema is None else \
                (1 - self.alpha) * self.ema + self.alpha * dt
        return is_straggler


class FaultTolerantLoop:
    """Wraps a Trainer with injection, restart and straggler handling."""

    def __init__(self, trainer: Trainer, injector: FailureInjector,
                 monitor: StragglerMonitor | None = None,
                 max_restarts: int = 8):
        self.trainer = trainer
        self.injector = injector
        self.monitor = monitor or StragglerMonitor()
        self.max_restarts = max_restarts
        self.restarts = 0
        self.log = []

    def run(self, total_steps: int):
        while self.trainer.step < total_steps:
            remaining = total_steps - self.trainer.step
            try:
                self._run_segment(remaining)
            except SimulatedNodeFailure as e:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                self.log.append({"event": "failure", "step":
                                 self.trainer.step, "msg": str(e)})
                self._recover()
        return self.trainer.history

    def _run_segment(self, steps: int):
        def on_step(step, metrics, dt):
            self.monitor.observe(step, dt)
            self.injector.check(step)

        self.trainer.run(steps, on_step=on_step)

    def _recover(self):
        """Restore from the newest snapshot and resume (re-mesh hook)."""
        ck = self.trainer.ckpt
        if ck is None or ck.latest_step() is None:
            raise RuntimeError("failure before the first checkpoint")
        step = self.trainer.restore()
        self.log.append({"event": "restart", "resumed_step": step,
                         "restarts": self.restarts})
