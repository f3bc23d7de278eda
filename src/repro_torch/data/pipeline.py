"""Data pipeline: deterministic sharded token streams with prefetch.

Two sources behind one interface:
  * SyntheticLM  — a seeded Zipf-ish token stream with local n-gram structure
    (so tiny models have something learnable);
  * FileTokens   — memory-mapped binary token file (uint16/uint32), chunked
    into (batch, seq+1) windows.

Determinism contract (fault tolerance): ``batch_at(step)`` is a pure
function of (seed, step, shard), so a restart from a checkpoint replays
identical batches and the resilient loop ends at the fault-free parameters.
Prefetch runs a daemon thread keeping a small queue of ready batches.  The
batches are numpy arrays, bit for bit the JAX package's (its
``data/pipeline.py``, of which this is the port's own copy).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np

__all__ = ["SyntheticLM", "FileTokens", "Prefetcher", "make_batch_fn"]


@dataclass(frozen=True)
class SyntheticLM:
    """Deterministic synthetic language: Zipf unigrams + bigram coupling.

    next-token = f(prev) with probability `coupling`, else Zipf sample —
    learnable structure whose PPL floor a tiny model can approach.
    """
    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    coupling: float = 0.7
    shard: int = 0
    n_shards: int = 1

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.shard]))
        b = self.batch // self.n_shards
        # zipf unigram draws clipped to vocab
        base = rng.zipf(1.3, size=(b, self.seq_len + 1))
        base = (base - 1) % self.vocab
        # deterministic bigram map: f(t) = (a*t + c) % V
        f = (base * 31 + 17) % self.vocab
        use_bigram = rng.random((b, self.seq_len + 1)) < self.coupling
        toks = base.copy()
        for t in range(1, self.seq_len + 1):
            toks[:, t] = np.where(use_bigram[:, t],
                                  (toks[:, t - 1] * 31 + 17) % self.vocab,
                                  base[:, t])
        return {"inputs": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


@dataclass(frozen=True)
class FileTokens:
    """Binary token file source: shard-strided windows, step-keyed."""
    path: str
    vocab: int
    seq_len: int
    batch: int
    dtype: str = "uint16"
    shard: int = 0
    n_shards: int = 1

    def _mm(self) -> np.ndarray:
        return np.memmap(self.path, dtype=self.dtype, mode="r")

    def batch_at(self, step: int) -> dict:
        data = self._mm()
        b = self.batch // self.n_shards
        span = self.seq_len + 1
        n_windows = len(data) // span
        idx = (step * self.batch + self.shard * b + np.arange(b)) % n_windows
        rows = np.stack([data[i * span:(i + 1) * span] for i in idx])
        rows = rows.astype(np.int64) % self.vocab
        return {"inputs": rows[:, :-1].astype(np.int32),
                "labels": rows[:, 1:].astype(np.int32)}


def make_batch_fn(source) -> "callable":
    return source.batch_at


class Prefetcher:
    """Daemon-thread prefetch of step-keyed batches (depth-bounded queue)."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.next_step = start_step
        self._stop = threading.Event()
        self.t = threading.Thread(target=self._run, daemon=True)
        self.t.start()

    def _run(self):
        step = self.next_step
        while not self._stop.is_set():
            batch = self.source.batch_at(step)
            self.q.put((step, batch))
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self.q.get()

    def stop(self):
        self._stop.set()
        try:
            self.q.get_nowait()
        except queue.Empty:
            pass
