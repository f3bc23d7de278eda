"""ServeEngine: slot-based continuous batching over per-sequence KV caches.

The dense/ring branch of the JAX package's engine.  The engine owns one set
of decode caches sized for ``max_slots`` sequences and runs ONE batched
decode step for the whole batch every tick, with static shapes.  Per slot:

  FREE --admit--> PREFILL --tail consumed--> DECODE --eos/max--> FREE

Admission prefills the longest pack-aligned prompt prefix through the LPSA
streaming dataflow (batch 1; the whole prompt when no layer streams) and
copies the resulting caches into the slot's rows; the rest of the prompt is
fed one token per tick through the shared decode step while the other slots
keep generating.  Every cache row carries its own positions, so slots at
different depths share one batch.  Time is virtual: 1 unit == one decode
step; requests carry arrival times in those units.  A request's tokens do
not depend on its batch-mates: every kernel sums each row in a fixed order
and sampling is greedy per row (batch invariance).

Sampling is greedy: a request with ``temperature > 0`` raises
NotImplementedError (ROADMAP).  The caches are updated in place.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import model as MD
from repro_torch.models.model import TernaryLM
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.sampler import greedy
from repro_torch.serve.scheduler import FifoScheduler, Request

__all__ = ["ServeEngine", "EngineStats", "RequestResult"]

FREE, PREFILL, DECODE = 0, 1, 2


@dataclass
class RequestResult:
    uid: int
    tokens: np.ndarray            # generated ids (eos included when hit)
    prompt_len: int
    arrival: int                  # vtime units (1 = one batched decode step)
    admit_vtime: int
    first_token_vtime: int
    finish_vtime: int

    @property
    def latency_steps(self) -> int:
        return self.finish_vtime - self.arrival

    @property
    def ttft_steps(self) -> int:
        return self.first_token_vtime - self.arrival


@dataclass
class EngineStats:
    max_slots: int = 0
    decode_steps: int = 0         # batched step invocations
    active_slot_steps: int = 0    # sum over steps of |active slots|
    generated_tokens: int = 0     # sampled tokens delivered to requests
    prefill_tokens: int = 0       # prompt tokens absorbed via batch-1 prefill
    wall_seconds: float = 0.0
    decode_seconds: float = 0.0   # host clock over decode steps (each ends
                                  # in a device sync: the sampled ids)

    @property
    def slot_utilization(self) -> float:
        """Mean fraction of decode-batch rows doing useful work."""
        return self.active_slot_steps / max(1, self.decode_steps * max(1, self.max_slots))


class _Slot:
    __slots__ = ("state", "req", "input_tok", "input_pos", "tail", "tail_idx",
                 "out", "admit_vtime", "first_tok_vtime")

    def __init__(self):
        self.state = FREE
        self.req = None


class ServeEngine:
    """Continuous-batching engine over a ``TernaryLM``.

    ``device`` must be the model's device, CUDA unless ``device="cpu"`` is
    passed; ``serve_sparse=False`` serves global layers with full caches.
    """

    def __init__(self, model: TernaryLM, config: ServeConfig | None = None, *,
                 device=None, serve_sparse: bool = True):
        dev = resolve_device(device)
        if model.device.type != dev.type:
            raise ValueError(f"model lies on {model.device}, engine asked for {dev}")
        config = config or ServeConfig()
        cfg = model.cfg
        self.model, self.cfg, self.config = model, cfg, config
        self.device = model.device
        self.serve_sparse = serve_sparse
        self.max_slots, self.max_len = config.max_slots, config.max_len
        self.scheduler = FifoScheduler(aging_steps=config.aging_steps)
        self.stats = EngineStats(max_slots=config.max_slots)
        self.vtime = 0
        sw = [A.kind_sink_window(cfg, k, serve_sparse) for k in cfg.layer_kinds()]
        self._has_full = any(s >= A.FULL_SINK for s, _ in sw)
        has_stream = any(s < A.FULL_SINK for s, _ in sw)
        # streaming prefill consumes whole packs; the prompt tail decodes
        self._chunk = (cfg.lpsa.chunk if cfg.lpsa else 256) if has_stream else 1
        self.caches = MD.init_caches(cfg, self.max_slots, self.max_len,
                                     device=self.device, serve_sparse=serve_sparse)
        self._empty1 = MD.init_caches(cfg, 1, self.max_len, device=self.device,
                                      serve_sparse=serve_sparse)
        self._slots = [_Slot() for _ in range(self.max_slots)]
        self._results: dict[int, RequestResult] = {}
        self._pending_uids: set[int] = set()

    # -- public API -------------------------------------------------------

    def validate(self, req: Request) -> None:
        """Raise when ``req`` cannot be served."""
        if req.temperature > 0:
            raise NotImplementedError(
                f"request {req.uid}: temperature sampling is not ported yet; "
                f"the port serves greedy requests (ROADMAP.md, queue 1)")
        if req.prompt_len < 1:
            raise ValueError(f"request {req.uid}: empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError(f"request {req.uid}: max_new_tokens must be >= 1")
        prompt = np.asarray(req.prompt)
        if prompt.ndim != 1 or not np.issubdtype(prompt.dtype, np.integer) \
                or prompt.min() < 0 or prompt.max() >= self.cfg.vocab:
            raise ValueError(f"request {req.uid}: the prompt must be token ids "
                             f"in [0, {self.cfg.vocab})")
        if self._has_full and req.prompt_len + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"request {req.uid}: prompt {req.prompt_len} + gen "
                f"{req.max_new_tokens} exceeds max_len {self.max_len} "
                f"(a full-cache layer is active)")

    def submit(self, req: Request) -> None:
        self.validate(req)
        in_flight = {s.req.uid for s in self._slots if s.req is not None}
        if req.uid in in_flight or req.uid in self._pending_uids:
            raise ValueError(f"request uid {req.uid} already in flight")
        if req.uid in self._results:
            raise ValueError(f"request uid {req.uid} has an unclaimed result; "
                             f"pop_result/drain_results it before resubmitting")
        self._pending_uids.add(req.uid)
        self.scheduler.add(req)

    def pop_result(self, uid: int) -> RequestResult | None:
        """Claim (and remove) one finished result, releasing its uid."""
        return self._results.pop(uid, None)

    def drain_results(self) -> dict[int, RequestResult]:
        out, self._results = self._results, {}
        return out

    @property
    def num_active(self) -> int:
        return sum(s.state != FREE for s in self._slots)

    def run(self) -> dict[int, RequestResult]:
        """Drain the queue; returns uid -> RequestResult."""
        t0 = time.perf_counter()
        while self.scheduler or self.num_active:
            self._admit_ready()
            if not self.num_active:
                nxt = self.scheduler.next_arrival()
                if nxt is None:
                    break
                self.vtime = max(self.vtime, nxt)   # idle fast-forward
                continue
            self.step_decode()
        self.stats.wall_seconds += time.perf_counter() - t0
        return self.drain_results()

    # -- admission --------------------------------------------------------

    def _admit_ready(self) -> None:
        for i, slot in enumerate(self._slots):
            if slot.state != FREE:
                continue
            req = self.scheduler.pop_ready(self.vtime)
            if req is None:
                return
            self._admit(i, req)

    def _admit(self, idx: int, req: Request) -> None:
        slot = self._slots[idx]
        p = req.prompt_len
        prefix = (p // self._chunk) * self._chunk
        self._pending_uids.discard(req.uid)
        slot.req = req
        slot.admit_vtime = self.vtime
        slot.out = []
        slot.first_tok_vtime = None
        logits = None
        if prefix > 0:
            tokens = torch.as_tensor(np.asarray(req.prompt[:prefix]), dtype=torch.long,
                                     device=self.device)[None]
            logits, small = MD.prefill(self.model, tokens, max_len=self.max_len,
                                       serve_sparse=self.serve_sparse)
            self.stats.prefill_tokens += prefix
            self._insert(idx, small)
        else:
            self._insert(idx, self._empty1)
        if prefix == p:
            tok = int(greedy(logits[0]))
            slot.state = DECODE
            slot.first_tok_vtime = self.vtime
            slot.input_pos = p
            self._deliver(idx, tok)
        else:
            slot.state = PREFILL
            slot.tail = [int(x) for x in np.asarray(req.prompt[prefix:])]
            slot.tail_idx = 1
            slot.input_pos = prefix
            slot.input_tok = slot.tail[0]

    def _insert(self, idx: int, small: list) -> None:
        """Overwrite slot ``idx``'s rows of every layer with a batch-1 cache."""
        for big, sm in zip(self.caches, small):
            for key, buf in big.items():
                buf[idx].copy_(sm[key][0])

    # -- the decode tick --------------------------------------------------

    def step_decode(self) -> None:
        t0 = time.perf_counter()
        b = self.max_slots
        tok = np.zeros((b,), np.int64)
        t = np.zeros((b,), np.int64)     # free rows: position 0, a don't-care
        active = 0
        for i, s in enumerate(self._slots):
            if s.state == FREE:
                continue
            active += 1
            tok[i] = s.input_tok
            t[i] = s.input_pos
        logits, _ = MD.decode_step(self.model, self.caches,
                                   torch.from_numpy(tok).to(self.device),
                                   torch.from_numpy(t).to(self.device),
                                   serve_sparse=self.serve_sparse)
        next_tok = greedy(logits).cpu().numpy()
        self.stats.decode_seconds += time.perf_counter() - t0
        self.stats.decode_steps += 1
        self.stats.active_slot_steps += active
        self.vtime += 1
        for i, s in enumerate(self._slots):
            if s.state == PREFILL:
                if s.tail_idx < len(s.tail):
                    s.input_pos += 1
                    s.input_tok = s.tail[s.tail_idx]
                    s.tail_idx += 1
                else:
                    # the last prompt token went in this tick -> first sample
                    s.state = DECODE
                    s.first_tok_vtime = self.vtime
                    self._deliver(i, int(next_tok[i]))
            elif s.state == DECODE:
                self._deliver(i, int(next_tok[i]))

    def _deliver(self, idx: int, tok: int) -> None:
        s = self._slots[idx]
        s.out.append(tok)
        s.input_tok = tok
        s.input_pos = s.req.prompt_len + len(s.out) - 1
        self.stats.generated_tokens += 1
        if self._finished(s, tok):
            self._retire(idx)

    @staticmethod
    def _finished(s: _Slot, tok: int) -> bool:
        return (len(s.out) >= s.req.max_new_tokens
                or (s.req.eos_id is not None and tok == s.req.eos_id))

    def _retire(self, idx: int) -> None:
        s = self._slots[idx]
        r = s.req
        self._results[r.uid] = RequestResult(
            uid=r.uid, tokens=np.asarray(s.out, np.int32), prompt_len=r.prompt_len,
            arrival=r.arrival, admit_vtime=s.admit_vtime,
            first_token_vtime=s.first_tok_vtime, finish_vtime=self.vtime)
        # a finished request's KV does not outlive it
        self._insert(idx, self._empty1)
        s.state = FREE
        s.req = None
        s.tail = None
