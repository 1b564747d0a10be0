"""Fault-tolerant training runtime, ported from
src/repro/runtime/fault_tolerance.py.

Wraps a step function with:

  * periodic async checkpoints (checkpoint/checkpointing.py) and restart
    from the latest one,
  * failure detection: a non-finite loss, errors raised by the step,
    injected faults (the tests use the injector to show that a restart
    recovers),
  * a straggler watchdog: each step's wall time against an EMA; a step
    past ``straggler_factor`` x the EMA is recorded and logged (the
    mitigation hook).

One difference from JAX's: ``run`` also takes ``batches`` as a function
of the first step (``lambda step: iterator``), called at the start and
after every restart, so a step replayed from a checkpoint reads the batch
it read the first time (JAX's runtime keeps consuming one iterator, so a
replayed step gets the next batch instead; ROADMAP.md, Queue 3).
"""
from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Any, Callable, Dict, Optional

from repro_torch.checkpoint import checkpointing

log = logging.getLogger("repro_torch.runtime")


@dataclasses.dataclass
class RuntimeConfig:
    ckpt_dir: str = "checkpoints"
    ckpt_every: int = 50
    max_restarts: int = 3
    straggler_factor: float = 3.0
    ema_alpha: float = 0.2


class FaultInjector:
    """Deterministic fault injection for tests and examples."""

    def __init__(self, fail_at_steps=()):
        self.fail_at = set(fail_at_steps)
        self.fired = set()

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected node failure at step {step}")


class TrainRuntime:
    def __init__(self, cfg: RuntimeConfig, state: Dict[str, Any],
                 step_fn: Callable,
                 injector: Optional[FaultInjector] = None):
        self.cfg = cfg
        self.state = state                 # {"params":..., "opt_state":...}
        self.step_fn = step_fn
        self.injector = injector
        self.ckpt = checkpointing.AsyncCheckpointer()
        self.step = 0
        self.restarts = 0
        self.step_ema: Optional[float] = None
        self.straggler_events = []

    # -- checkpoint/restore ------------------------------------------------
    def _save(self):
        self.ckpt.save(self.cfg.ckpt_dir, self.step, self.state,
                       extra={"step": self.step})

    def try_resume(self) -> bool:
        last = checkpointing.latest_step(self.cfg.ckpt_dir)
        if last is None:
            return False
        self.state, extra = checkpointing.restore(self.cfg.ckpt_dir, last,
                                                  self.state)
        self.step = extra.get("step", last)
        log.warning("resumed from checkpoint step %d", self.step)
        return True

    # -- main loop -----------------------------------------------------------
    def run(self, batches, num_steps: int, on_metrics=None):
        """Run to ``num_steps``.  ``batches``: an iterator, or a function
        of the first step returning one (see the module's note)."""
        while self.step < num_steps:
            it = batches(self.step) if callable(batches) else batches
            try:
                self._run_inner(it, num_steps, on_metrics)
                break
            except Exception as e:  # node failure / injected fault
                self.restarts += 1
                log.warning("failure at step %d: %s (restart %d/%d)",
                            self.step, e, self.restarts,
                            self.cfg.max_restarts)
                if self.restarts > self.cfg.max_restarts:
                    raise
                self.ckpt.wait()
                if not self.try_resume():
                    log.warning("no checkpoint; restarting from step 0 state")
            finally:
                if callable(batches) and hasattr(it, "close"):
                    it.close()
        self.ckpt.wait()
        return self.state

    def _run_inner(self, batches, num_steps, on_metrics):
        for batch in batches:
            if self.step >= num_steps:
                return
            t0 = time.perf_counter()
            if self.injector is not None:
                self.injector.maybe_fail(self.step)
            out = self.step_fn(self.state, batch, self.step)
            self.state = out["state"]
            metrics = out.get("metrics", {})
            loss = metrics.get("loss")
            if loss is not None:
                loss = float(loss)         # waits for the step's device work
                if not math.isfinite(loss):
                    raise FloatingPointError(
                        f"non-finite loss {loss} at step {self.step}")
            dt = time.perf_counter() - t0
            self._watch_straggler(dt)
            self.step += 1
            if self.step % self.cfg.ckpt_every == 0:
                self._save()
            if on_metrics is not None:
                on_metrics(self.step, metrics, dt)

    def _watch_straggler(self, dt: float):
        if self.step_ema is None:
            self.step_ema = dt
            return
        if dt > self.cfg.straggler_factor * self.step_ema and self.step > 3:
            self.straggler_events.append((self.step, dt, self.step_ema))
            log.warning("straggler: step %d took %.3fs (ema %.3fs) — "
                        "mitigation hook fired", self.step, dt, self.step_ema)
        a = self.cfg.ema_alpha
        self.step_ema = (1 - a) * self.step_ema + a * dt
