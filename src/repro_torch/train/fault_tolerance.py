"""Fault tolerance: restart manager and straggler monitor.

Port of ``repro.train.fault_tolerance``, in its arithmetic and control
flow:

* **checkpoint/restart** — ``RestartManager.run`` executes the step loop,
  saves every ``save_every`` steps and at the last (atomic publish), and
  on any exception restores the newest complete checkpoint and resumes;
  the retry budget ``max_failures`` is bounded, so a deterministic crash
  cannot loop forever.  As in the reference, a fault before the first
  checkpoint replays from the loop's first step on the state as it stands
  (already stepped), so such a run ends past ``n_steps``;
* **straggler mitigation** — a per-step wall-time EMA; steps slower than
  ``factor`` x EMA are logged and counted.  A step's time ends when its
  loss reaches the host (``float(metrics["loss"])``), which waits for the
  card, so the monitor times steps and not kernel launches.

The reference's elastic re-mesh (``remesh``) needs the placement of the
mesh-sharded paths and raises here.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field

from repro_torch.train import checkpoint

log = logging.getLogger("repro_torch.ft")


@dataclass
class StragglerMonitor:
    factor: float = 3.0
    ema: float | None = None
    alpha: float = 0.2
    slow_steps: list = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        slow = self.ema is not None and dt > self.factor * self.ema
        if slow:
            self.slow_steps.append((step, dt, self.ema))
            log.warning("straggler: step %d took %.3fs (ema %.3fs)",
                        step, dt, self.ema)
        self.ema = dt if self.ema is None else \
            (1 - self.alpha) * self.ema + self.alpha * dt
        return slow


@dataclass
class RestartManager:
    ckpt_dir: str
    save_every: int = 50
    max_failures: int = 3
    monitor: StragglerMonitor = field(default_factory=StragglerMonitor)
    failures: int = 0

    def run(self, state, step_fn, batch_fn, n_steps: int, fault_hook=None):
        """Run ``n_steps`` of ``state, metrics = step_fn(state,
        batch_fn(i))`` with checkpoint/restart; ``metrics["loss"]`` is
        read on the host after each step.  ``fault_hook(i)`` may raise to
        simulate a lost node (tests use this)."""
        start = int(state.step)
        i = start
        while i < n_steps:
            try:
                t0 = time.monotonic()
                if fault_hook is not None:
                    fault_hook(i)
                state, metrics = step_fn(state, batch_fn(i))
                float(metrics["loss"])          # waits for the step
                self.monitor.observe(i, time.monotonic() - t0)
                i += 1
                if i % self.save_every == 0 or i == n_steps:
                    checkpoint.save(self.ckpt_dir, i, state)
            except Exception as e:  # noqa: BLE001 — any fault is restartable
                self.failures += 1
                log.warning("step %d failed (%s); restart %d/%d",
                            i, e, self.failures, self.max_failures)
                if self.failures > self.max_failures:
                    raise
                last = checkpoint.latest_step(self.ckpt_dir)
                if last is None:
                    i = start   # nothing saved yet: replay from the top
                    continue
                state = checkpoint.restore(self.ckpt_dir, last, state)
                i = last
        return state


def remesh(state, old_dir: str, step: int, new_shardings):
    """The reference's elastic re-mesh: restore ``step`` re-sharded onto a
    new mesh.  Not ported: it needs the mesh placement of the sharded
    paths."""
    raise NotImplementedError(
        "remesh (restore onto a new device mesh) is not ported yet: it "
        "needs the placement of ROADMAP A4")
