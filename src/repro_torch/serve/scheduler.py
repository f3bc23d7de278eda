"""Request queue for the continuous-batching engine.

A copy of the JAX package's ``serve/scheduler.py`` (pure Python).  Time is
virtual: one unit = one batched decode step.  Two admission orders:

* ``FifoScheduler`` orders by priority then arrival, with **aging**: a
  request's effective priority decays by one level per ``aging_steps`` of
  queue wait, which reduces to the static heap key
  ``priority * aging_steps + arrival`` (``aging_steps=0`` keeps the strict,
  starvation-prone order).
* ``DeadlineScheduler``: earliest effective deadline first on the same
  machinery.  A request with ``slo_steps`` must finish by
  ``arrival + slo_steps``; one without gets a default budget plus an aging
  penalty per priority level, so the static key encodes both urgency and
  the anti-starvation decay.  The HTTP front door's default order.
"""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Any

__all__ = ["Request", "FifoScheduler", "DeadlineScheduler"]


@dataclass(frozen=True)
class Request:
    """One generation request.

    prompt: (P,) integer token ids, or (P, D) float embeddings for the
    stub-frontend models (``prompt_len`` is P either way).  temperature 0
    = greedy; top_k applies as the engine's ``ServeConfig.top_k`` says.
    priority: lower runs first (ties by arrival, then submission order).
    eos_id ends the request when sampled.  slo_steps: an optional deadline,
    the request should finish within this many virtual steps of its
    arrival; the deadline scheduler orders admission by it and the engine
    can preempt over-budget slots to rescue it (``ServeConfig.preemption``).
    """
    uid: int
    prompt: Any
    max_new_tokens: int
    temperature: float = 0.0
    eos_id: int | None = None
    arrival: int = 0
    priority: int = 0
    slo_steps: int | None = None

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    def deadline(self, default_slo: int, aging_steps: int) -> int:
        """Effective completion deadline in virtual steps."""
        if self.slo_steps is not None:
            return self.arrival + self.slo_steps
        return self.arrival + default_slo + self.priority * max(aging_steps, 1)


@dataclass
class FifoScheduler:
    """Aged priority-then-arrival FIFO over future-dated requests.

    `pop_ready(now)` only releases requests whose arrival time has passed,
    so a replayed trace admits requests exactly when they "arrive" even
    though the whole trace is submitted up front.  Two heaps: future-dated
    entries wait in an arrival-ordered heap and migrate to the ready heap
    as the clock passes them — amortized O(log N) per request.

    Aging: with ``aging_steps = A > 0`` a request's effective priority at
    time ``now`` is ``priority - (now - arrival) / A``.  Comparing two
    requests, ``p_i - (now - a_i)/A < p_j - (now - a_j)/A`` iff
    ``p_i*A + a_i < p_j*A + a_j`` — time cancels, so the heap key
    ``(priority*A + arrival, priority, arrival)`` implements continuous
    aging without ever re-keying the heap.  A starved low-priority request
    therefore overtakes a fresh high-priority one after waiting
    ``A * (priority gap)`` steps.  ``aging_steps = 0`` keeps the legacy
    strict ``(priority, arrival)`` order (starvation-prone under a
    saturating high-priority stream).
    """
    aging_steps: int = 64
    _future: list = field(default_factory=list)   # (arrival, tie, req)
    _ready: list = field(default_factory=list)    # (rank, tie, req)
    _tie: itertools.count = field(default_factory=itertools.count)
    # O(1) next_arrival: a monotone lower bound on the ready entries'
    # arrivals, maintained at migration time and cleared when the ready
    # heap drains.  Every ready entry's arrival had already passed when it
    # migrated, so the bound (like the exact min) is always <= the current
    # clock — the idle fast-forward `vtime = max(vtime, next_arrival())`
    # behaves identically without rescanning the heap per idle tick.
    _ready_min_arrival: int | None = None

    def _rank(self, req: Request) -> tuple:
        if self.aging_steps:
            return (req.priority * self.aging_steps + req.arrival,
                    req.priority, req.arrival)
        return (req.priority, req.arrival)

    def add(self, req: Request) -> None:
        heapq.heappush(self._future, (req.arrival, next(self._tie), req))

    def _migrate(self, now: int) -> None:
        while self._future and self._future[0][0] <= now:
            arrival, tie, req = heapq.heappop(self._future)
            heapq.heappush(self._ready, (self._rank(req), tie, req))
            if self._ready_min_arrival is None \
                    or arrival < self._ready_min_arrival:
                self._ready_min_arrival = arrival

    def pop_ready(self, now: int) -> Request | None:
        """Best admissible request (arrival <= now), else None.
        Future-dated entries never block admissible ones."""
        self._migrate(now)
        if self._ready:
            req = heapq.heappop(self._ready)[-1]
            if not self._ready:
                self._ready_min_arrival = None
            return req
        return None

    def peek_ready(self, now: int) -> Request | None:
        """Best admissible request without removing it (the engine's
        preemption check inspects the head before deciding to make room)."""
        self._migrate(now)
        return self._ready[0][-1] if self._ready else None

    def next_arrival(self) -> int | None:
        """Earliest arrival among queued requests (for idle fast-forward).

        O(1): when the ready heap is non-empty this returns a lower bound
        on its arrivals (exact until the entry holding the minimum pops);
        since every ready arrival has already passed, any such bound leaves
        `max(vtime, next_arrival())` unchanged — only the future-heap head,
        which is exact, ever moves the clock."""
        cands = []
        if self._ready and self._ready_min_arrival is not None:
            cands.append(self._ready_min_arrival)
        if self._future:
            cands.append(self._future[0][0])
        return min(cands, default=None)

    def __len__(self) -> int:
        return len(self._future) + len(self._ready)

    def __bool__(self) -> bool:
        return bool(self._future or self._ready)


@dataclass
class DeadlineScheduler(FifoScheduler):
    """Earliest-effective-deadline-first admission (EDF).

    Primary key: the request's effective deadline, ``arrival + slo_steps``
    with an SLO, else ``arrival + default_slo + priority * aging_steps`` (the
    aging term keeps low-priority work without an SLO from starving: its
    deadline is fixed while fresh arrivals keep receiving later ones).  Ties
    break by raw priority, then arrival.  The key is static per request, so
    the heap never re-keys.
    """
    default_slo: int = 256

    def deadline(self, req: Request) -> int:
        return req.deadline(self.default_slo, self.aging_steps)

    def _rank(self, req: Request) -> tuple:
        return (self.deadline(req), req.priority, req.arrival)
