"""Live serving telemetry: per-request SLO records and rolling engine gauges.

A copy of the JAX package's ``serve/metrics.py`` (pure Python).
``Telemetry`` is a sink the engine calls as it serves (attach with
``Telemetry(engine=engine)`` or ``telemetry.attach(engine)``):

  * ``on_admit(req, vtime)``   queue-wait accounting at slot claim
  * ``on_tick(engine, n, dt)`` once per batched decode step (wall dt)
  * ``on_finish(result, eng)`` once per retired request
  * ``on_reshard(engine, ...)`` once per elastic recovery (a device loss
    survived: mesh shrink and replay); logs a ``{"type": "reshard", ...}``
    JSON line with the recovery latency and the surviving topology

From those it keeps (a) cumulative counters that must agree with
``EngineStats`` (tokens, requests, preemptions), (b) a rolling window of
recent ticks and requests for live gauges (tok/s over wall time, slot
utilization, TTFT / latency / queue-wait percentiles, SLO attainment) and
(c) an optional JSON-lines flight recorder: one ``{"type": "request", ...}``
line per finished request and a ``{"type": "tick", ...}`` snapshot every
``snapshot_every`` ticks.  ``snapshot()`` is the body of the HTTP
``/metrics`` endpoint.

The port has no silent kernel fallback (a kernel wrapper on a CUDA tensor
launches its kernel or raises), so the snapshot has no ``kernel_fallbacks``
key.

Thread safety: the engine thread writes, any thread may ``snapshot()``; one
lock covers the rolling state.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque

import numpy as np

__all__ = ["Telemetry"]


def _pct(values, q) -> float:
    if not values:
        return 0.0
    return float(np.percentile(np.asarray(values, np.float64), q))


class Telemetry:
    def __init__(self, engine=None, jsonl_path: str | None = None,
                 window: int = 256, snapshot_every: int = 64):
        self._lock = threading.Lock()
        self._t0 = time.time()
        self._snapshot_every = snapshot_every
        # rolling per-tick records: (wall_dt, active_slots, tokens_delta)
        self._ticks: deque = deque(maxlen=window)
        # rolling finished-request records (dicts, see on_finish)
        self._recent: deque = deque(maxlen=window)
        # cumulative counters (they track EngineStats)
        self.tokens_out = 0
        self.requests_finished = 0
        self.queue_wait_steps = 0
        self.slo_tracked = 0
        self.slo_met = 0
        self.preemptions = 0
        self.reshards = 0
        self.recovery_seconds = 0.0
        self.ticks_seen = 0
        self._last_generated = None   # EngineStats.generated_tokens baseline
        self._f = open(jsonl_path, "a") if jsonl_path else None
        if engine is not None:
            self.attach(engine)

    def attach(self, engine) -> "Telemetry":
        engine.telemetry = self
        # only tokens generated after attachment count
        self._last_generated = engine.stats.generated_tokens
        return self

    def _sync_tokens_locked(self, engine) -> int:
        """Fold the growth of EngineStats.generated_tokens into tokens_out:
        the per-tick samples and the first tokens sampled at admission."""
        gen = engine.stats.generated_tokens
        if self._last_generated is None:
            self._last_generated = 0
        delta = gen - self._last_generated
        self._last_generated = gen
        self.tokens_out += delta
        return delta

    # -- engine-facing hooks ----------------------------------------------

    def on_admit(self, req, vtime: int) -> None:
        with self._lock:
            self.queue_wait_steps += vtime - req.arrival

    def on_tick(self, engine, n_active: int, wall_dt: float) -> None:
        with self._lock:
            delta = self._sync_tokens_locked(engine)
            self.ticks_seen += 1
            self._ticks.append((wall_dt, n_active, delta))
            due = (self._f is not None
                   and self.ticks_seen % self._snapshot_every == 0)
        if due:
            self._write({"type": "tick", "vtime": engine.vtime,
                         **self._gauges(engine)})

    def on_finish(self, result, engine) -> None:
        rec = {
            "uid": result.uid,
            "prompt_len": result.prompt_len,
            "new_tokens": int(len(result.tokens)),
            "queue_wait_steps": result.queue_wait_steps,
            "ttft_steps": result.ttft_steps,
            "latency_steps": result.latency_steps,
            "slo_steps": result.slo_steps,
            "slo_met": result.slo_met,
            "preempted": result.preempted,
        }
        with self._lock:
            self._sync_tokens_locked(engine)
            self.requests_finished += 1
            self._recent.append(rec)
            if result.preempted:
                self.preemptions += 1
            if result.slo_steps is not None:
                self.slo_tracked += 1
                self.slo_met += int(result.slo_met)
        if self._f is not None:
            self._write({"type": "request", "ts": time.time(), **rec})

    def on_reshard(self, engine, *, lost: int, seconds: float, in_flight: int) -> None:
        topo = getattr(engine, "topology", None)
        with self._lock:
            self.reshards += 1
            self.recovery_seconds += seconds
        if self._f is not None:
            self._write({
                "type": "reshard", "ts": time.time(), "vtime": engine.vtime,
                "lost_devices": lost, "recovery_seconds": round(seconds, 6),
                "in_flight_replayed": in_flight,
                "topology": (None if topo is None else
                             {"pods": topo.pods, "dp": topo.dp, "tp": topo.tp}),
            })

    # -- reads ------------------------------------------------------------

    def _gauges(self, engine=None) -> dict:
        """Rolling-window gauges (the caller holds no lock; this takes it)."""
        with self._lock:
            ticks = list(self._ticks)
            recent = list(self._recent)
            totals = {
                "tokens_out": self.tokens_out,
                "requests_finished": self.requests_finished,
                "queue_wait_steps_total": self.queue_wait_steps,
                "slo_tracked": self.slo_tracked,
                "slo_met": self.slo_met,
                "preemptions": self.preemptions,
                "reshards": self.reshards,
                "recovery_seconds": round(self.recovery_seconds, 6),
                "ticks": self.ticks_seen,
            }
        wall = sum(t[0] for t in ticks)
        toks = sum(t[2] for t in ticks)
        slots = engine.max_slots if engine is not None else 1
        util = sum(t[1] for t in ticks) / max(1, len(ticks) * slots)
        return {
            "uptime_s": round(time.time() - self._t0, 3),
            "rolling": {
                "window_ticks": len(ticks),
                "tok_s": toks / wall if wall > 0 else 0.0,
                "slot_utilization": util,
                "ttft_steps_p50": _pct([r["ttft_steps"] for r in recent], 50),
                "ttft_steps_p95": _pct([r["ttft_steps"] for r in recent], 95),
                "latency_steps_p50": _pct([r["latency_steps"] for r in recent], 50),
                "latency_steps_p95": _pct([r["latency_steps"] for r in recent], 95),
                "queue_wait_steps_p50": _pct([r["queue_wait_steps"] for r in recent], 50),
            },
            "totals": totals,
            "slo_attainment": (totals["slo_met"] / totals["slo_tracked"]
                               if totals["slo_tracked"] else None),
        }

    def snapshot(self, engine=None) -> dict:
        """The live gauge dict (the ``/metrics`` body); with an engine, also
        its authoritative stats and pool occupancy."""
        out = self._gauges(engine)
        if engine is not None:
            st = engine.stats
            out["engine"] = {
                "vtime": engine.vtime,
                "active_slots": engine.num_active,
                "queue_depth": len(engine.scheduler),
                "max_slots": engine.max_slots,
                "decode_steps": st.decode_steps,
                "generated_tokens": st.generated_tokens,
                "prefill_tokens": st.prefill_tokens,
                "slot_utilization": st.slot_utilization,
                "preemptions": st.preemptions,
                "reshards": st.reshards,
                "recovery_seconds": round(st.recovery_seconds, 6),
            }
            pool = engine.pool_stats()
            out["pool"] = {k: pool[k] for k in
                           ("layout", "pages_in_use", "pages_peak",
                            "bytes_in_use", "num_pages")}
        return out

    # -- jsonl plumbing ----------------------------------------------------

    def _write(self, obj: dict) -> None:
        line = json.dumps(obj)
        with self._lock:
            if self._f is None:
                return
            self._f.write(line + "\n")
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None
