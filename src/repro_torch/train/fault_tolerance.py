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

* **elastic re-mesh** — ``remesh`` restores a checkpoint onto a new
  placement: a device, or a :class:`~repro_torch.parallel.Mesh` (this
  rank's device; every rank of an SPMD run holds the whole state).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field

import torch

from repro_torch.parallel import Mesh
from repro_torch.train import checkpoint
from repro_torch.train.optimizer import AdamWState
from repro_torch.train.train_loop import TrainState

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


def _moved(tree, dev: torch.device):
    """``tree`` (a tensor, or dicts, tuples and NamedTuples of them) with
    every tensor on ``dev``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, dict):
        return {k: _moved(v, dev) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_moved(v, dev) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_moved(v, dev) for v in tree)
    return tree


def remesh(state, old_dir: str, step: int, placement):
    """Elastic scaling: restore checkpoint ``step`` onto a new placement.

    ``placement`` is a device or a :class:`~repro_torch.parallel.Mesh`
    (this rank's device).  The like-state moves there (a ``TrainState``'s
    model with ``nn.Module.to``, in place) and is filled from the
    checkpoint by ``checkpoint.restore``; returns it."""
    dev = (placement.device if isinstance(placement, Mesh)
           else torch.device(placement))
    if isinstance(state, TrainState):
        opt = state.opt
        state = TrainState(
            model=state.model.to(dev),
            opt=AdamWState(step=opt.step.to(dev), m=_moved(opt.m, dev),
                           v=_moved(opt.v, dev)),
            step=state.step.to(dev), error=_moved(state.error, dev))
    else:
        state = _moved(state, dev)
    return checkpoint.restore(old_dir, step, state)
