"""Fault tolerance: the trainer's checkpoint/restart loop, failure
injection, stragglers; the serving engine raises the same ``WorkerFailure``
from a ``FaultInjector`` at the top of a decode step and survives it by
``ServeEngine.recover`` (``fault_lost_devices`` ranks lost a failure).

The port's own copy of the JAX package's ``distributed/fault.py`` (pure
Python).  The job survives by (i) periodic checkpoints
(``repro_torch.checkpoint``), (ii) a restartable step loop that reloads the
last good step on any worker fault, and (iii) a straggler monitor flagging
slow steps (EWMA z-score).  Failures are injected by ``FaultInjector`` on a
deterministic schedule; the loop must end at exactly the parameters of a
fault-free run, since the data pipeline is step-keyed.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

__all__ = ["FaultInjector", "StragglerMonitor", "resilient_loop", "WorkerFailure"]


class WorkerFailure(RuntimeError):
    """Simulated node loss (preemption, a link flap, host OOM)."""


@dataclass
class FaultInjector:
    """Deterministically raise WorkerFailure before the given step indices."""
    fail_at: tuple[int, ...] = ()
    fired: set = field(default_factory=set)

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise WorkerFailure(f"injected failure at step {step}")


@dataclass
class StragglerMonitor:
    """EWMA step-time tracker; flags steps slower than mean + k*std."""
    alpha: float = 0.1
    k: float = 3.0
    warmup: int = 5
    mean: float = 0.0
    var: float = 0.0
    n: int = 0
    flagged: list = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        self.n += 1
        if self.n <= self.warmup:
            self.mean = dt if self.n == 1 else \
                (1 - self.alpha) * self.mean + self.alpha * dt
            return False
        is_straggler = dt > self.mean + self.k * max(self.var, 1e-12) ** 0.5
        d = dt - self.mean
        self.mean += self.alpha * d
        self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        if is_straggler:
            self.flagged.append((step, dt))
        return is_straggler


def resilient_loop(
    *,
    init_state: Any,
    step_fn: Callable[[Any, int], Any],
    n_steps: int,
    save_fn: Callable[[Any, int], None],
    restore_fn: Callable[[], tuple[Any, int]],
    ckpt_every: int = 10,
    injector: FaultInjector | None = None,
    monitor: StragglerMonitor | None = None,
    max_restarts: int = 8,
) -> tuple[Any, dict]:
    """Run step_fn n_steps times, checkpointing and surviving failures.

    restore_fn() -> (state, next_step); save_fn(state, step) persists state
    *after* `step` completed.  On WorkerFailure the loop restores the last
    checkpoint and replays — the data pipeline must be step-keyed so replay
    is deterministic (data.pipeline seeds by step).
    """
    state, step = init_state, 0
    restarts = 0
    save_fn(state, 0)
    while step < n_steps:
        try:
            if injector is not None:
                injector.maybe_fail(step)
            t0 = time.monotonic()
            state = step_fn(state, step)
            dt = time.monotonic() - t0
            if monitor is not None:
                monitor.observe(step, dt)
            step += 1
            if step % ckpt_every == 0:
                save_fn(state, step)
        except WorkerFailure:
            restarts += 1
            if restarts > max_restarts:
                raise
            state, step = restore_fn()
    save_fn(state, n_steps)
    stats = {"restarts": restarts,
             "stragglers": list(monitor.flagged) if monitor else []}
    return state, stats
