"""ServeEngine: slot-based continuous batching over per-sequence KV caches.

The dense/ring and paged branches of the JAX package's engine.  The engine
owns one set of decode caches sized for ``max_slots`` sequences and runs ONE
batched decode step for the whole batch every tick, with static shapes.  Per
slot:

  FREE --admit--> PREFILL --tail consumed--> DECODE --eos/max--> FREE

Admission prefills the longest pack-aligned prompt prefix through the LPSA
streaming dataflow (batch 1; the whole prompt when no layer streams) and
copies the resulting caches into the slot's rows; the rest of the prompt is
fed one token per tick through the shared decode step while the other slots
keep generating.  Every cache row carries its own positions, so slots at
different depths share one batch.  Time is virtual: 1 unit == one decode
step; requests carry arrival times in those units.  A request's tokens do
not depend on its batch-mates: every kernel sums each row in a fixed order,
and a row's sampling key is ``fold_in(fold_in(PRNGKey(seed), uid),
counter)``, the JAX engine's, with counter the number of tokens the request
has generated (batch invariance; serve/sampler.py).

The decode step reads static buffers (token ids, positions, the page table;
temperatures, uids and counters for sampling) that each tick fills in
place.  On CUDA the engine captures the step with greedy sampling into a
``torch.cuda.CUDAGraph`` at construction, after a warm-up step on a side
stream, and every tick replays it; a capture that fails raises.  A second,
small graph holds the temperature / top-k sampler over the first graph's
logits (it shares the first graph's memory pool); a tick replays it after
the first only when some active row has a temperature above 0, so a greedy
tick replays exactly the one graph.  On the CPU the step runs eagerly and
computes the same function.  The caches are allocated before the capture
and only ever written in place, since the graph holds their storage.  A
replay bumps no counter in ``kernels.ops``: the engine adds the launches of
one capture (``launches_per_replay``) per replay.

Admission follows ``ServeConfig.scheduler`` (FIFO with aging, or earliest
deadline first over ``Request.slo_steps``); with ``preemption`` a slot over
its own deadline is truncated to rescue a queue head that would miss its
SLO.  ``policy="wave"`` degrades the same machinery to lock-step gang
scheduling (admit only when every slot is free), the baseline.  The hooks
``telemetry`` (a ``serve.metrics.Telemetry``), ``on_token`` and
``on_finish`` let the HTTP front door (serve/server.py) stream tokens;
``run_forever`` drives the engine from the server's engine thread, and a
lock covers submission, admission and the results.

``ServeConfig(layout="paged")`` swaps the per-slot full caches for a
block-paged KV pool: one refcounted page arena per full-attention layer,
per-slot int32 page tables in a static buffer, pages allocated lazily as a
slot crosses a page boundary, and a radix-trie prefix index
(serve.kvpool.RadixIndex) through which admission reuses the pages and ring
states of the longest cached pack-aligned prompt prefix instead of
prefilling it again.  Shared pages are copy-on-write; retiring a slot
releases its references and scrubs the pages that fall free.  A config
without full-attention layers (the LPSA path) gets no pages and still
shares exact prefix states through the trie.

Each layer's slot state is the cache its kind resolves to
(``layout_summary``): ring, full or paged KV for attention, or the mamba,
rwkv and gla recurrent states, which are O(1) a slot; an engine without
full-cache layers accepts any prompt length.  A recurrent state prefills
with the rest of the model: with the whole prompt at admission only when no
layer streams (rwkv6-3b, gla-1.3b, or LPSA off), else with the pack-aligned
prefix, the tail fed through the decode step (zamba2-2.7b's mamba layers
beside its streaming attention).  A free row decodes token 0 at position 0
(t = -1 under the paged layout); its mamba buffer writes land in row 0 of
its slot, a don't-care that never folds, so a retired slot's carry stays
zero.

The stub-frontend models (``MD.uses_embeds``: musicgen-medium,
pixtral-12b) take float32 embedding prompts (P, d_model): admission
prefills the pack-aligned prefix's rows as they are, and each tail row is
fed through two more static buffers, ``forced`` (B,) and ``forced_x`` (B,
d_model) float32, which the step reads in place of the row's token
embedding; generated tokens and free rows carry ``forced = False``.  Such
prompts carry no token ids, so the paged layout serves them without the
prefix trie.

MoE configs decode with the no-drop expert capacity (models/moe.py
``decode_capacity``: the batch, ``max_slots``, idle rows included, so the
step's shapes stay static); ``ServeConfig.moe_expert_capacity`` optionally
bounds the per-expert load of a tick by deferring admissions instead of
dropping tokens.

SPMD serving: under ``ServeConfig.topology`` (a ``distributed.plan.
Topology``) the engine is one rank of a ``torch.distributed`` world of dp x
tp processes, every one running the same host scheduler over the same host
state.  The engine takes the full serving model as a host copy and cuts its
rank's local model from it (``models.model.shard_model``): every
projection, DAS step and attention launches the port's kernels on the
rank's shard, with one sum over "model" a block half.  The slot rows shard
over the data axes (when ``max_slots`` divides by dp; else every data group
runs every row); a tick's logits are gathered to (B, V) on every rank
before the sampler, so every rank samples the same tokens.  An admission's
prefill runs on every rank (replicated over data, as the paged arena is),
and each data group keeps the rows of its own slots.  Such a step runs
eagerly: a gloo collective cannot be captured in a CUDA graph.

Recovery (the JAX package's elastic recovery): a ``fault.WorkerFailure``
in a tick (``fault_injector``, checked at the top of every step) makes the
run loops call ``recover``: every active slot is snapshotted (its request
and the tokens generated so far), the topology shrinks by
``fault_lost_devices`` (``Topology.shrink``: tp kept while it divides the
survivors), the ranks build the shrunk mesh's process groups over the first
survivors, the lost ranks leave (``retired``), the survivors cut their
shards anew from the host copy, and the snapshots are admitted again before
any fresh request: the prompt prefix prefills, the rest of the prompt and
the generated tokens are fed back through the decode step, and sampling
resumes at the request's own counter, so its tokens continue unchanged.
Without a topology, recovery rebuilds the device state in place.

Kernel modes (``ServeConfig.kernel_mode``, kernels/ops.py): the engine runs
its model calls (the decode step, its capture, the admissions' prefills)
under its mode.  Under "tuned" it first tunes every GEMM and attention
shape its steps will take (``_autotune_warmup``: the projections at
``max_slots`` rows and at a pack, the decode and pack attention), eagerly
and before the decode step's CUDA graph is captured, since the graph bakes
in the configs chosen at capture; ``stats.autotune_timed_runs`` counts the
timed candidate runs, zero once the cache holds every shape.  Under a
topology a mode other than "auto" or "sharded" warns and the ranks run the
kernels on their shards ("sharded"), as the JAX package forces its GSPMD
mode there; "ref" refuses a CUDA engine.
"""

from __future__ import annotations

import threading
import time
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.distributed import collectives, fault
from repro_torch.distributed.plan import ShardingPlan
from repro_torch.kernels import autotune, ops
from repro_torch.models import attention as A
from repro_torch.models import kvcache as KV
from repro_torch.models import layers as L
from repro_torch.models import model as MD
from repro_torch.models import transformer as T
from repro_torch.models.model import TernaryLM
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.kvpool import PagePool, PrefixEntry, RadixIndex
from repro_torch.serve.sampler import fold_keys, greedy, make_sampler, prng_key
from repro_torch.serve.scheduler import DeadlineScheduler, FifoScheduler, Request

__all__ = ["ServeEngine", "EngineStats", "RequestResult", "check_serve_config"]

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
    admitted_with_active: int = 0  # slots already mid-stream at admission
                                   # (admitted in an earlier tick)
    slo_steps: int | None = None   # the deadline budget the request carried
    preempted: bool = False        # truncated by the deadline rescue

    @property
    def latency_steps(self) -> int:
        return self.finish_vtime - self.arrival

    @property
    def ttft_steps(self) -> int:
        return self.first_token_vtime - self.arrival

    @property
    def queue_wait_steps(self) -> int:
        return self.admit_vtime - self.arrival

    @property
    def slo_met(self) -> bool:
        """Finished within its deadline budget (a preempted request never
        counts as met); a request without an SLO meets it vacuously."""
        if self.slo_steps is None:
            return True
        return not self.preempted and self.latency_steps <= self.slo_steps


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
    warmup_steps: int = 0         # eager steps run before the graph capture
    graph_replays: int = 0        # decode steps run as CUDA graph replays
    sampling_steps: int = 0       # decode steps that ran the sampler (a row
                                  # with temperature > 0)
    # paged-pool accounting (zero under the per-slot layout)
    prefix_hits: int = 0          # admissions that reused a cached prefix
    prompt_tokens_reused: int = 0  # prompt tokens absorbed via prefix reuse
    cow_copies: int = 0           # copy-on-write page copies
    prefix_evictions: int = 0     # trie entries evicted to free pages
    pool_peak_pages: int = 0      # peak pages in use during this run
    moe_capacity_deferrals: int = 0  # admissions deferred by the MoE
                                     # expert-capacity bound (ticks a ready
                                     # request waited for it)
    preemptions: int = 0          # over-budget slots truncated to rescue a
                                  # deadline-critical queued request
    # elastic recovery (zero unless a WorkerFailure was survived)
    reshards: int = 0             # snapshot -> mesh shrink -> reshard cycles
    recovery_seconds: float = 0.0  # wall time spent rebuilding device state
    autotune_timed_runs: int = 0  # timed candidate runs spent in the warmup

    @property
    def slot_utilization(self) -> float:
        """Mean fraction of decode-batch rows doing useful work."""
        return self.active_slot_steps / max(1, self.decode_steps * max(1, self.max_slots))


def check_serve_config(cfg, config: ServeConfig) -> None:
    """Raise ValueError when ``config`` cannot serve the model config
    ``cfg``: an expert-capacity bound needs MoE layers."""
    if config.moe_expert_capacity and cfg.moe is None:
        raise ValueError(
            f"moe_expert_capacity={config.moe_expert_capacity} is set "
            f"but config {cfg.name!r} has no MoE layers; drop the bound "
            f"or serve a MoE config")


class _Slot:
    __slots__ = ("state", "req", "input_tok", "input_x", "input_pos", "tail", "tail_idx",
                 "out", "admit_vtime", "first_tok_vtime", "admitted_with_active",
                 "pages", "page_budget")

    def __init__(self):
        self.state = FREE
        self.req = None
        self.input_x = None        # a prompt row being fed (stub frontends)
        self.pages = None          # paged layout: logical -> physical page ids
        self.page_budget = 0       # pages this slot may still allocate


class ServeEngine:
    """Continuous-batching engine over a ``TernaryLM``.

    ``device`` must be the model's device, CUDA unless ``device="cpu"`` is
    passed; ``config`` is a ``ServeConfig`` (slots, cache layout, top-k,
    seed, policy, scheduler, topology); ``serve_sparse=False`` serves
    global layers with full caches;
    ``cuda_graph=False`` steps eagerly on CUDA too, the baseline that the
    card-only tests and chip_smoke.py hold the captured step against.
    Under a topology ``model`` is the full serving model, a host copy on
    any device, and ``device`` the rank's own: the engine cuts its shard.
    """

    def __init__(self, model: TernaryLM, config: ServeConfig | None = None, *,
                 device=None, serve_sparse: bool = True, cuda_graph: bool = True):
        dev = resolve_device(device)
        config = config or ServeConfig()
        if config.topology is None and model.device.type != dev.type:
            raise ValueError(f"model lies on {model.device}, engine asked for {dev}")
        cfg = model.cfg
        check_serve_config(cfg, config)
        self.model, self.cfg, self.config = model, cfg, config
        self.device = model.device if config.topology is None else dev
        self.serve_sparse = serve_sparse
        self.max_slots, self.max_len = config.max_slots, config.max_len
        self.policy = config.policy
        if config.scheduler == "deadline":
            self.scheduler = DeadlineScheduler(aging_steps=config.aging_steps,
                                               default_slo=config.slo_default_steps)
        else:
            self.scheduler = FifoScheduler(aging_steps=config.aging_steps)
        self._preempt = config.preemption
        self.stats = EngineStats(max_slots=config.max_slots)
        # live-serving hooks: the HTTP front door streams tokens through
        # on_token / on_finish; a metrics.Telemetry attached as .telemetry
        # observes admissions, ticks and finishes
        self.telemetry = None
        self.on_token = None      # callable(uid, token_id) per sampled token
        self.on_finish = None     # callable(RequestResult) at retirement
        # submit / pop_result may run on another thread than run_forever's:
        # the lock orders them against admission and retirement.  The HTTP
        # front door makes every engine call on the engine thread; its event
        # loop reads only single attributes (len(scheduler), num_active,
        # vtime, the pool's counters) and takes no lock, so an admission's
        # prefill, which runs under the lock, never stalls the event loop
        self._lock = threading.RLock()
        self._moe_slot_cap = config.moe_expert_capacity if cfg.moe is not None else 0
        self.vtime = 0
        # over the attention layers only: a recurrent layer keeps O(1) state
        sw = [A.kind_sink_window(cfg, k, serve_sparse) for k in cfg.layer_kinds()
              if k in T.ATTN_KINDS]
        self._has_full = any(s >= A.FULL_SINK for s, _ in sw)
        has_stream = any(s < A.FULL_SINK for s, _ in sw)
        # streaming prefill consumes whole packs; the prompt tail decodes.
        # Without a streaming layer (full caches, recurrent states) the whole
        # prompt prefills at admission
        self._chunk = (cfg.lpsa.chunk if cfg.lpsa else 256) if has_stream else 1
        self._uses_embeds = MD.uses_embeds(cfg)

        # ---- paged pool (layout="paged") --------------------------------
        self._paged = config.layout == "paged"
        # embedding prompts have no token ids to key the trie on
        self._share = self._paged and config.prefix_sharing and not self._uses_embeds
        self._page_size = config.page_size
        # only full-attention layers become arenas; a pure ring config still
        # shares exact prefix states through the trie, with zero pages
        self._pages_per_seq = config.pages_per_seq if self._has_full else 0
        self._num_pages = config.resolved_num_pages() if self._pages_per_seq else 0
        self._slots = [_Slot() for _ in range(self.max_slots)]
        self._results: dict[int, RequestResult] = {}
        self._pending_uids: set[int] = set()
        self._base_key = prng_key(config.seed, self.device)
        self._sampler = make_sampler(config.top_k)
        self._cuda_graph = cuda_graph
        self.launches_per_replay: dict[str, int] = {}

        # ---- SPMD / elastic-recovery state ------------------------------
        self.host_model = model if config.topology is not None else None   # full weights
        self._topology = config.topology   # live: shrinks on recovery
        self._mesh = None
        self._replays: list[dict] = []     # slot snapshots awaiting re-admission
        self.retired = False               # a rank lost in a recovery: serves no more
        # a fault.FaultInjector checked at the top of each tick; a failure it
        # triggers costs fault_lost_devices ranks
        self.fault_injector = None
        self.fault_lost_devices = 1

        # ---- kernel mode ------------------------------------------------
        mode = ops.KernelMode.parse(config.kernel_mode)
        if config.topology is not None and mode.value not in ("auto", "sharded"):
            warnings.warn(f"kernel_mode={mode.value!r} is a single-device path; under a "
                          f"Topology every rank runs the kernels on its shard ('sharded')",
                          stacklevel=2)
            mode = ops.KernelMode.SHARDED
        if mode.behaviour == "ref" and self.device.type == "cuda":
            raise ValueError("kernel_mode 'ref' runs the plain versions: it serves on "
                             "device='cpu' only")
        self.kernel_mode = mode.value
        self._dispatch = mode.behaviour
        self.autotune_cache = None
        if self._dispatch == "tuned":
            self.autotune_cache = autotune.AutotuneCache(device=self.device)
            self._autotune_warmup()
        self._build_device_state()

    def _autotune_warmup(self) -> None:
        """Tune every (op, shape) the serving steps will take, eagerly.

        GEMM shapes (packed weights only: the int8 trits keep das_gemv's one
        config): the projection pairs at the decode rows (``max_slots``) and
        at the streaming-prefill pack, each under the route its K takes
        (``das_ternary_gemm`` where the DAS block divides K, else
        ``ternary_gemm`` on dense rows).  Attention: each layer kind's
        decode over its cache, and its pack when it streams.  Shapes that
        miss at dispatch time (another prompt length of a full prefill, an
        SSM's own projections) run what "auto" runs, the kernel at its
        built-in config, with zero timed runs."""
        cfg, tc, cache = self.cfg, self.cfg.ternary, self.autotune_cache
        dtype = L.torch_dtype(cfg.dtype)
        before = cache.timed_runs
        tune = lambda op, dims: autotune.tune(op, device=self.device, cache=cache,  # noqa: E731
                                              budget=None, **dims)
        if tc.enabled and tc.serve_format == "packed":
            pairs = {(cfg.d_model, cfg.q_dim), (cfg.d_model, cfg.kv_dim),
                     (cfg.q_dim, cfg.d_model), (cfg.d_model, cfg.d_ff),
                     (cfg.d_ff, cfg.d_model)}
            das = tc.das
            for m in sorted({self.max_slots, self._chunk}):
                for k, n in sorted(pairs):
                    if das is not None and k % das.block == 0:
                        tune("das_ternary_gemm", autotune.gemm_dims(
                            m=m, k=k, n=n, keep=das.keep, block=das.block, dtype=dtype))
                    else:
                        tune("ternary_gemm", autotune.gemm_dims(m=m, k=k, n=n, dtype=dtype))
        for kind in sorted(set(cfg.layer_kinds()) & set(T.ATTN_KINDS)):
            sink, window = A.kind_sink_window(cfg, kind, self.serve_sparse)
            ring = sink < A.FULL_SINK
            heads = dict(hq=cfg.n_heads, hkv=cfg.n_kv_heads, d=cfg.head_dim_, sink=sink,
                         window=window, dtype=dtype)
            tune("sparse_attn", autotune.attn_dims(
                lq=1, lk=sink + window if ring else self.max_len,
                **heads))
            if ring and self._chunk > 1:
                tune("sparse_attn", autotune.attn_dims(
                    lq=self._chunk, lk=sink + window + self._chunk, round_scores=True,
                    **heads))
        self.stats.autotune_timed_runs += cache.timed_runs - before

    def _mode_scope(self):
        """The engine's kernel mode over a block of model calls."""
        return ops.kernel_mode(self._dispatch, self.autotune_cache)

    def _build_device_state(self) -> None:
        """(Re)build what lives on the device: under a topology the mesh's
        process groups and this rank's local model; the KV pool,
        radix index and page table; the caches (this rank's slot rows); the
        step's static buffers; and on CUDA without a topology the captured
        graphs.  Called at construction and again by ``recover``."""
        cfg, b, n_seq = self.cfg, self.max_slots, self._pages_per_seq
        self._rows = (0, b)
        self._pool = PagePool(self._num_pages, self._page_size) if n_seq else None
        self._radix = RadixIndex() if self._share else None
        if self._topology is not None:
            ranks = None if self._mesh is None else self._mesh.ranks
            self._mesh = self._topology.build_mesh(ranks)
            if not self._mesh.member:
                self.retired = True
                self.model = self.caches = None
                return
            self.model = MD.shard_model(self.host_model, self._mesh, self.device)
            dpx = self._topology.dp_extent
            if b % dpx == 0:
                d = self._mesh.dp_index
                self._rows = (d * b // dpx, (d + 1) * b // dpx)

        # the per-layer slot-state union, the caches' source of truth
        # (layout_summary): paged / full / ring KV for the attention layers,
        # rwkv / gla recurrent states; a rank's caches hold its own slot rows
        # and kv heads
        lcfg, nb = self.model.cfg, self._rows[1] - self._rows[0]
        self._layer_specs = [T.layer_cache_spec(lcfg, kind, nb, self.max_len,
                                                L.torch_dtype(cfg.dtype),
                                                serve_sparse=self.serve_sparse,
                                                page_size=self._page_size if n_seq else 0,
                                                num_pages=self._num_pages)
                             for kind in cfg.layer_kinds()]
        self.caches = [KV.init_cache(lcfg, spec, self.device) for spec in self._layer_specs]
        self._empty1 = MD.init_caches(lcfg, 1, self.max_len, device=self.device,
                                      serve_sparse=self.serve_sparse)
        self._paged_layers = [KV.is_paged(c) for c in self.caches]
        self._rest_is_empty = self._paged and all(self._paged_layers)
        self._page_bytes = sum(leaf.nbytes // leaf.shape[0]
                               for c, p in zip(self.caches, self._paged_layers) if p
                               for leaf in c.values())

        # ---- the decode step's static inputs ----------------------------
        # host arrays (pinned on CUDA) that each tick fills for every slot,
        # and the device buffers the step reads: the model's inputs for this
        # rank's rows, the sampler's for all; the page table only when a
        # layer is paged
        pin = self.device.type == "cuda"

        def buffers(shape, dtype, rows=False):
            host = torch.zeros(shape, dtype=dtype, pin_memory=pin)
            dev_shape = (nb,) + tuple(shape[1:]) if rows else shape
            return host, host.numpy(), torch.zeros(dev_shape, dtype=dtype, device=self.device)

        self._tok_host, self._tok_np, self._tok = buffers((b,), torch.int64, True)
        self._t_host, self._t_np, self._t = buffers((b,), torch.int64, True)
        self._pt_host = self._pt_np = self._pt = None
        if n_seq:
            self._pt_host, self._pt_np, self._pt = buffers((b, n_seq), torch.int32, True)
        self._forced = self._forced_x = None
        if self._uses_embeds:
            self._forced_host, self._forced_np, self._forced = buffers((b,), torch.bool, True)
            self._fx_host, self._fx_np, self._forced_x = buffers((b, cfg.d_model),
                                                                 torch.float32, True)
        # sampling: a row's temperature, uid and generated-token count
        self._temps_host, self._temps_np, self._temps = buffers((b,), torch.float32)
        self._uids_host, self._uids_np, self._uids = buffers((b,), torch.int32)
        self._ctr_host, self._ctr_np, self._ctr = buffers((b,), torch.int32)
        self._graph = self._sample_graph = None
        self._next = self._logits = self._sampled = None
        if self.device.type == "cuda" and self._cuda_graph and self._topology is None:
            self._capture()

    # -- the captured step ------------------------------------------------

    def _step_fn(self) -> torch.Tensor:
        """The decode step over the static buffers -> logits (B, V) float32
        (a rank's rows gathered over the data axes)."""
        with self._mode_scope():
            logits, _ = MD.decode_step(self.model, self.caches, self._tok, self._t,
                                       serve_sparse=self.serve_sparse,
                                       page_table=self._pt, forced=self._forced,
                                       forced_x=self._forced_x)
        if self._rows != (0, self.max_slots):
            logits = collectives.gather(logits, self._mesh, "dp", 0, self._rows[0],
                                        self.max_slots)
        return logits

    def _sample_fn(self, logits: torch.Tensor) -> torch.Tensor:
        """Each row's token by its temperature (greedy at 0) over the static
        sampling buffers -> ids (B,)."""
        keys = fold_keys(self._base_key, self._uids, self._ctr)
        return self._sampler(logits, keys, self._temps)

    def _capture(self) -> None:
        """Warm the step and the sampler up on a side stream (kernels built,
        allocator and libraries settled), capture the step with greedy
        sampling into one CUDA graph and the sampler over its logits into a
        second one in the same memory pool, then empty the caches again,
        since the warm-up wrote them."""
        self._t_np[:] = -1 if self._paged else 0
        self._t.copy_(self._t_host)
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            logits = self._step_fn()
            greedy(logits)
            self._sample_fn(logits)
        main.wait_stream(side)
        self.stats.warmup_steps += 1
        graph = torch.cuda.CUDAGraph()
        with ops.launches_recorded() as per_replay:
            with torch.cuda.graph(graph):
                self._logits = self._step_fn()
                self._next = greedy(self._logits)
        self._graph = graph
        self.launches_per_replay = per_replay
        sample_graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(sample_graph, pool=graph.pool()):
            self._sampled = self._sample_fn(self._logits)
        self._sample_graph = sample_graph
        for c in self.caches:
            for key, buf in c.items():
                if key.startswith("pos"):
                    buf.fill_(-1)
                else:
                    buf.zero_()

    def _run_step(self, sampling: bool) -> np.ndarray:
        """Copy the host inputs to the static buffers, run the step (a graph
        replay on CUDA) and return the ids, sampled when ``sampling`` (some
        row has a temperature above 0) else greedy: the step's one sync."""
        b0, b1 = self._rows
        self._tok.copy_(self._tok_host[b0:b1], non_blocking=True)
        self._t.copy_(self._t_host[b0:b1], non_blocking=True)
        if self._pt is not None:
            self._pt.copy_(self._pt_host[b0:b1], non_blocking=True)
        if self._forced is not None:
            self._forced.copy_(self._forced_host[b0:b1], non_blocking=True)
            self._forced_x.copy_(self._fx_host[b0:b1], non_blocking=True)
        if sampling:
            self._temps.copy_(self._temps_host, non_blocking=True)
            self._uids.copy_(self._uids_host, non_blocking=True)
            self._ctr.copy_(self._ctr_host, non_blocking=True)
            self.stats.sampling_steps += 1
        if self._graph is None:
            logits = self._step_fn()
            next_tok = self._sample_fn(logits) if sampling else greedy(logits)
        else:
            self._graph.replay()
            ops.add_launches(self.launches_per_replay)
            self.stats.graph_replays += 1
            next_tok = self._next
            if sampling:
                self._sample_graph.replay()
                next_tok = self._sampled
        return next_tok.cpu().numpy()

    def _sample_first(self, logits: torch.Tensor, req: Request, counter: int) -> int:
        """A request's token from one row of logits (V,) (a prefill's or a
        stored entry's), keyed by its uid and ``counter``."""
        if req.temperature <= 0:
            return int(greedy(logits))
        dev = self.device
        keys = fold_keys(self._base_key, torch.tensor([req.uid], device=dev),
                         torch.tensor([counter], device=dev))
        temps = torch.tensor([req.temperature], dtype=torch.float32, device=dev)
        return int(self._sampler(logits[None], keys, temps)[0])

    # -- public API -------------------------------------------------------

    def validate(self, req: Request) -> None:
        """Raise ValueError when ``req`` cannot be served.  Reads the request
        and the engine's configuration only, so any thread may call it (the
        HTTP front door answers 400 from its event loop)."""
        if not -2 ** 31 <= req.uid < 2 ** 31:
            raise ValueError(f"request uid {req.uid} does not fit int32 (the "
                             f"sampling key folds it as int32)")
        if req.prompt_len < 1:
            raise ValueError(f"request {req.uid}: empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError(f"request {req.uid}: max_new_tokens must be >= 1")
        prompt = np.asarray(req.prompt)
        if self._uses_embeds:
            d = self.cfg.d_model
            if prompt.ndim != 2 or prompt.shape[1] != d \
                    or not np.issubdtype(prompt.dtype, np.floating):
                raise ValueError(f"request {req.uid}: {self.cfg.name} takes a prompt of "
                                 f"float embeddings (P, {d}); got {prompt.dtype} "
                                 f"{prompt.shape}")
        elif prompt.ndim != 1 or not np.issubdtype(prompt.dtype, np.integer) \
                or prompt.min() < 0 or prompt.max() >= self.cfg.vocab:
            raise ValueError(f"request {req.uid}: the prompt must be token ids "
                             f"in [0, {self.cfg.vocab})")
        if self._has_full and req.prompt_len + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"request {req.uid}: prompt {req.prompt_len} + gen "
                f"{req.max_new_tokens} exceeds max_len {self.max_len} "
                f"(a full-cache layer is active)")
        if self._pages_per_seq:
            worst = -(-(req.prompt_len + req.max_new_tokens) // self._page_size)
            usable = self._pool.num_pages - 1
            if worst > usable:
                raise ValueError(
                    f"request {req.uid}: needs up to {worst} KV pages but "
                    f"the pool holds {usable} (raise num_pages or page_size)")

    def submit(self, req: Request) -> None:
        self.validate(req)
        with self._lock:
            # a duplicate uid in flight would collide in the results and share
            # a sampling-key stream; an unclaimed result would be clobbered
            in_flight = {s.req.uid for s in self._slots if s.req is not None}
            if req.uid in in_flight or req.uid in self._pending_uids:
                raise ValueError(f"request uid {req.uid} already in flight")
            if req.uid in self._results:
                raise ValueError(f"request uid {req.uid} has an unclaimed result; "
                                 f"pop_result/drain_results it before resubmitting")
            self._pending_uids.add(req.uid)
            self.scheduler.add(req)

    def pop_result(self, uid: int) -> RequestResult | None:
        """Claim (and remove) one finished result, releasing its uid; None
        when the uid has no finished result yet.  An always-on server pops
        each result as it finishes, so the results stay bounded."""
        with self._lock:
            return self._results.pop(uid, None)

    def drain_results(self) -> dict[int, RequestResult]:
        """Claim every finished result, releasing all their uids."""
        with self._lock:
            out, self._results = self._results, {}
            return out

    @property
    def num_active(self) -> int:
        return sum(s.state != FREE for s in self._slots)

    def reset_clock(self) -> None:
        """Zero the virtual clock and the stats between traces (caches and
        graphs survive: warm up before a timed replay).  Only valid when the
        engine is drained."""
        if self.num_active or self.scheduler or self._replays:
            raise RuntimeError("reset_clock on a non-drained engine")
        self.vtime = 0
        self.stats = EngineStats(max_slots=self.max_slots,
                                 warmup_steps=self.stats.warmup_steps,
                                 autotune_timed_runs=self.stats.autotune_timed_runs)

    def timed_replay(self, trace) -> dict[int, RequestResult]:
        """Replay ``trace`` twice, the first to warm up (allocator, kernel
        builds), and return the second run's results; the stats cover the
        second replay only."""
        for r in trace:
            self.submit(r)
        self.run()
        self.reset_clock()
        for r in trace:
            self.submit(r)
        return self.run()

    def run(self) -> dict[int, RequestResult]:
        """Drain the queue; returns uid -> RequestResult."""
        self.run_forever()
        return self.drain_results()

    def run_forever(self, *, should_stop=None, poll=None, idle_wait=None) -> None:
        """The engine's one step loop: ``run`` is this loop followed by
        ``drain_results``; the HTTP front door runs it on its engine thread
        and claims each result through ``on_finish`` / ``pop_result``.

        should_stop: checked once an iteration; True exits the loop.
        poll: called once an iteration before admission (the server moves
            its inbox into ``submit`` here, on the engine thread).
        idle_wait: called when nothing is active, admissible or
            future-dated; it should block briefly for new work and return
            False to exit.  None: an idle engine returns (``run``).

        With nothing active, a future-dated arrival fast-forwards the
        virtual clock to it.  A ``fault.WorkerFailure`` in a tick is
        survived by ``recover``; a rank that the recovery leaves out returns
        at once."""
        t0 = time.perf_counter()
        try:
            while not self.retired:
                if should_stop is not None and should_stop():
                    break
                if poll is not None:
                    poll()
                self._admit_ready()
                if self.num_active:
                    try:
                        self.step_decode()
                    except fault.WorkerFailure:
                        self.recover()
                    continue
                if self._replays:
                    continue      # a deferred replay admission: retry
                nxt = self.scheduler.next_arrival()
                if nxt is not None:
                    if nxt > self.vtime:
                        self.vtime = nxt   # idle fast-forward
                    # else a deferred (paged-pool) admission retries at once
                    continue
                if idle_wait is None or idle_wait() is False:
                    break
        finally:
            self.stats.wall_seconds += time.perf_counter() - t0

    # -- elastic recovery --------------------------------------------------

    @property
    def topology(self):
        """The live Topology (None on one device); shrinks on recovery."""
        return self._topology

    def sharding_plan(self) -> ShardingPlan | None:
        """The live topology's ShardingPlan of the full weights, with the
        cache specs of this engine's slots (None on one device)."""
        if self._topology is None:
            return None
        n_seq = self._pages_per_seq
        caches = MD.init_caches(self.cfg, self.max_slots, self.max_len, device="meta",
                                serve_sparse=self.serve_sparse,
                                page_size=self._page_size if n_seq else 0,
                                num_pages=self._num_pages)
        return ShardingPlan.for_tree(self.host_model, self._topology).with_caches(
            caches, batch=self.max_slots)

    def recover(self, lost_devices: int | None = None) -> None:
        """Survive a device loss mid-serving: snapshot every active slot
        (its request and the tokens generated so far), shrink the topology
        by ``lost_devices`` (default ``fault_lost_devices``), rebuild the
        device state (mesh, shards, caches; a rank outside the shrunk mesh
        retires) and queue the snapshots for re-admission: in-flight
        requests resume from their last token, never dropped.  One device
        rebuilds in place."""
        t0 = time.perf_counter()
        with self._lock:
            snaps = []
            for s in self._slots:
                if s.state == FREE:
                    continue
                snaps.append({"req": s.req, "out": list(s.out), "admit_vtime": s.admit_vtime,
                              # no first token yet: the replay stamps it
                              "first_tok_vtime": s.first_tok_vtime if s.out else None,
                              "admitted_with_active": s.admitted_with_active})
                s.state, s.req, s.input_x, s.tail, s.pages, s.page_budget = (
                    FREE, None, None, None, None, 0)
            lost = self.fault_lost_devices if lost_devices is None else lost_devices
            if self._topology is not None and lost > 0:
                self._topology = self._topology.shrink(self._topology.n_devices - lost)
            self._build_device_state()
            self._replays.extend(snaps)
            self.stats.reshards += 1
            dt = time.perf_counter() - t0
            self.stats.recovery_seconds += dt
        if self.telemetry is not None:
            self.telemetry.on_reshard(self, lost=lost, seconds=dt, in_flight=len(snaps))

    # -- admission --------------------------------------------------------

    def _admit_ready(self) -> None:
        with self._lock:
            self._admit_ready_locked()

    def _maybe_preempt(self) -> None:
        """Deadline rescue: when every slot is busy and the queue head would
        miss its SLO even if admitted now, truncate and retire the youngest
        active slot whose own deadline has passed (its result is delivered
        as it stands, ``preempted=True``).  Work that can still meet its SLO,
        and requests without one, are never preempted."""
        if self.num_active < self.max_slots:
            return
        head = self.scheduler.peek_ready(self.vtime)
        if head is None or head.slo_steps is None:
            return
        slack = head.arrival + head.slo_steps - self.vtime
        # steps to finish once admitted: the unabsorbed prompt tail feeds one
        # token a tick, then one tick a generated token
        prefix = (head.prompt_len // self._chunk) * self._chunk
        needed = (head.prompt_len - prefix) + head.max_new_tokens
        if slack > needed:
            return   # still meetable without making room
        victim = None
        for i, s in enumerate(self._slots):
            if s.state != DECODE or s.req is None or s.req.slo_steps is None:
                continue
            if self.vtime <= s.req.arrival + s.req.slo_steps:
                continue   # within budget: not preemptible
            if victim is None or s.admit_vtime > self._slots[victim].admit_vtime:
                victim = i
        if victim is not None:
            self.stats.preemptions += 1
            self._retire(victim, preempted=True)

    def _admit_ready_locked(self) -> None:
        # recovery replays outrank fresh admissions: these requests were
        # mid-stream when the failure hit and must never be dropped
        while self._replays:
            idx = next((i for i, s in enumerate(self._slots) if s.state == FREE), None)
            if idx is None or not self._replay_admit(idx, self._replays[0]):
                break   # no slot, or the pool is too tight now: retry next tick
            self._replays.pop(0)
        if self.policy == "wave" and self.num_active:
            return
        if self._preempt:
            self._maybe_preempt()
        for i, slot in enumerate(self._slots):
            if slot.state != FREE:
                continue
            if self._moe_slot_cap and self.num_active >= self._moe_slot_cap:
                # each active slot routes one token a tick, and an expert
                # takes at most one copy of a token: active slots bound the
                # per-expert load.  Hold admissions until a retirement.
                nxt = self.scheduler.next_arrival()
                if nxt is not None and nxt <= self.vtime:
                    self.stats.moe_capacity_deferrals += 1
                return
            req = self.scheduler.pop_ready(self.vtime)
            if req is None:
                return
            if not self._admit(i, req):
                # pool too tight right now: requeue and retry next tick
                # (retirements and evictions free pages; with no active slot
                # every page outside a slot is evictable, so the submit-time
                # capacity check guarantees progress)
                self._pending_uids.add(req.uid)
                self.scheduler.add(req)
                return

    def _admit(self, idx: int, req: Request) -> bool:
        """Claim slot ``idx`` for ``req``; False defers admission (paged
        layout only: the pool cannot cover the request's worst case yet)."""
        slot = self._slots[idx]
        prefix = (req.prompt_len // self._chunk) * self._chunk
        self._pending_uids.discard(req.uid)
        # slots already mid-stream (admitted in an earlier tick)
        slot.admitted_with_active = sum(1 for s2 in self._slots
                                        if s2.state != FREE and s2.admit_vtime < self.vtime)
        slot.req = req
        slot.admit_vtime = self.vtime
        slot.out = []
        slot.input_x = None
        slot.first_tok_vtime = None
        return self._admit_slot(idx, slot, req, prefix)

    def _admit_slot(self, idx: int, slot: _Slot, req: Request, prefix: int,
                    replay: tuple = (), notify: bool = True) -> bool:
        """Fill slot ``idx`` (its fields set) by the layout's admission;
        False backs off (paged only), leaving the slot FREE."""
        if self._paged:
            ok = self._admit_paged(idx, slot, req, prefix, replay, notify)
            if not ok:
                slot.req = None     # back off: the slot stays FREE
            return ok
        logits = None
        if prefix > 0:
            logits, small = self._prefill(req, prefix)
            self._insert(idx, small)
        else:
            self._insert(idx, self._empty1)
        self._start_slot(idx, slot, req, prefix, logits, replay, notify)
        return True

    def _replay_admit(self, idx: int, snap: dict) -> bool:
        """Re-admit a snapshot that ``recover`` took: prefill the prompt's
        prefix, then feed the rest of the prompt and the tokens already
        generated, so the slot's caches and sampling counter land where they
        were and its tokens continue unchanged."""
        slot, req = self._slots[idx], snap["req"]
        slot.admitted_with_active = snap["admitted_with_active"]
        slot.req = req
        slot.admit_vtime = snap["admit_vtime"]
        slot.out = list(snap["out"])
        slot.input_x = None
        slot.first_tok_vtime = None
        prefix = (req.prompt_len // self._chunk) * self._chunk
        if not self._admit_slot(idx, slot, req, prefix, tuple(snap["out"]), notify=False):
            return False
        if snap["first_tok_vtime"] is not None:
            slot.first_tok_vtime = snap["first_tok_vtime"]
        return True

    def _prefill(self, req: Request, prefix: int):
        """Batch-1 prefill of the prompt's first ``prefix`` tokens (or
        embedding rows, as float32) -> (logits (V,), batch-1 caches)."""
        dtype = torch.float32 if self._uses_embeds else torch.long
        inputs = torch.as_tensor(np.asarray(req.prompt[:prefix]), dtype=dtype,
                                 device=self.device)[None]
        with self._mode_scope():
            logits, small = MD.prefill(self.model, inputs, max_len=self.max_len,
                                       serve_sparse=self.serve_sparse)
        self.stats.prefill_tokens += prefix
        return logits[0], small

    def _start_slot(self, idx: int, slot: _Slot, req: Request, absorbed: int,
                    logits: torch.Tensor | None, replay: tuple = (),
                    notify: bool = True) -> None:
        """First token from the prefill's (or a stored entry's) logits when
        the whole prompt is absorbed, else feed the tail from ``absorbed``
        one token a tick.  ``replay`` (recovery) appends the tokens already
        generated to the tail, so the slot derives its state again through
        the decode step and sampling resumes at counter len(out)."""
        p = req.prompt_len
        if notify and self.telemetry is not None:
            self.telemetry.on_admit(req, self.vtime)
        if absorbed == p and not replay:
            slot.state = DECODE
            slot.first_tok_vtime = self.vtime
            slot.input_pos = p
            self._deliver(idx, self._sample_first(logits, req, len(slot.out)))
        else:
            slot.state = PREFILL
            rest = np.asarray(req.prompt[absorbed:])
            slot.tail = (list(rest.astype(np.float32)) if self._uses_embeds
                         else [int(x) for x in rest]) + list(replay)
            slot.tail_idx = 1
            slot.input_pos = absorbed
            self._feed(slot, slot.tail[0])

    def _feed(self, slot: _Slot, nxt) -> None:
        """One tail element into the decode step's input: an embedding row
        through ``forced_x``, a token id (a prompt's, or a replayed
        generated one) as the input token."""
        if self._uses_embeds and np.ndim(nxt) > 0:
            slot.input_tok, slot.input_x = 0, nxt
        else:
            slot.input_tok, slot.input_x = int(nxt), None

    def _insert(self, idx: int, small: list) -> None:
        """Overwrite slot ``idx``'s rows of every per-slot layer with a
        batch-1 cache (``small`` holds None for a layer it skips); a rank
        keeps the rows of its own slots only."""
        b0, b1 = self._rows
        if not b0 <= idx < b1:
            return
        for big, sm, paged in zip(self.caches, small, self._paged_layers):
            if paged or sm is None:
                continue
            for key, buf in big.items():
                buf[idx - b0].copy_(sm[key][0])

    # -- the paged layout's device pieces, all in place -------------------

    def _page_ids(self, pages) -> torch.Tensor:
        return torch.as_tensor(list(pages), dtype=torch.long, device=self.device)

    def _insert_paged(self, idx: int, small: list, fresh: list) -> None:
        """A fresh batch-1 prefill into the slot: each paged layer's dense
        rows [0, len(fresh) * page_size) go page by page into the arena
        pages ``fresh``; the per-slot layers copy rows."""
        self._insert(idx, small)
        if not fresh:
            return
        ps, ids = self._page_size, self._page_ids(fresh)
        n = len(fresh) * ps
        for big, sm, paged in zip(self.caches, small, self._paged_layers):
            if paged:
                for key in ("k", "v", "pos"):
                    dense = sm[key][0, :n]
                    big[f"{key}_pages"][ids] = dense.reshape(
                        len(fresh), ps, *dense.shape[1:]).to(big[f"{key}_pages"].dtype)

    def _snapshot_rest(self, small: list) -> list | None:
        """A copy of the per-slot layers of a batch-1 cache, None for the
        paged ones; None when every layer is paged."""
        if self._rest_is_empty:
            return None
        return [None if paged else {k: v.clone() for k, v in sm.items()}
                for sm, paged in zip(small, self._paged_layers)]

    def _copy_page(self, src: int, dst: int) -> None:
        """Copy-on-write: arena page ``src`` into ``dst`` in every paged layer."""
        for c, paged in zip(self.caches, self._paged_layers):
            if paged:
                for buf in c.values():
                    buf[dst].copy_(buf[src])

    def _scrub_pages(self, freed: list) -> None:
        """Positions of freed pages back to -1, so a reuse starts masked."""
        if not freed or not self._pages_per_seq:
            return
        ids = self._page_ids(freed)
        for c, paged in zip(self.caches, self._paged_layers):
            if paged:
                c["pos_pages"][ids] = -1

    # -- paged admission --------------------------------------------------

    def _admit_paged(self, idx: int, slot: _Slot, req: Request, prefix: int,
                     replay: tuple = (), notify: bool = True) -> bool:
        p, g, ps = req.prompt_len, req.max_new_tokens, self._page_size
        n_seq = self._pages_per_seq
        tokens = tuple(int(x) for x in np.asarray(req.prompt)) if self._share else None

        # -- the best cached prefix: an exact entry (pages, per-slot states
        # and logits, bitwise a fresh prefill of that prefix), or whole pages
        # inside the longest common prefix with any stored prompt, reusable
        # alone only when every layer is paged
        shared_len, kind, entry = 0, None, None
        if tokens is not None:
            best, donor, common = self._radix.lookup(tokens)
            if best is not None and best.length >= 1:
                shared_len, kind, entry = best.length, "exact", best
            if self._rest_is_empty and donor is not None and n_seq:
                l_pages = (min(common, p - 1) // ps) * ps  # keep >= 1 to feed
                if l_pages > shared_len:
                    shared_len, kind, entry = l_pages, "pages", donor

        total = -(-(p + g) // ps) if n_seq else 0
        register = tokens is not None and prefix > 0
        while True:
            if kind == "exact":
                n_cov = -(-shared_len // ps) if n_seq else 0
                shared_pages = tuple(entry.pages[:n_cov])
                # +1: a partial boundary page pinned by the trie gets copied
                # on this slot's first write into it
                budget = (total - n_cov + (1 if shared_len % ps else 0)) if n_seq else 0
                immediate = 0
            elif kind == "pages":
                n_cov = shared_len // ps
                shared_pages = tuple(entry.pages[:n_cov])
                budget = total - n_cov
                immediate = 0
            else:
                shared_pages = ()
                immediate = -(-prefix // ps) if n_seq else 0
                budget = total + (1 if n_seq and register and prefix % ps else 0)
            if not n_seq or self._paged_room(budget, shared_pages):
                break
            # headroom short for this plan: shared reuse -> fresh with
            # registration -> fresh without -> defer.  The bare fresh plan
            # needs exactly ``total`` pages, which the submit-time check
            # bounds, so with no active slot admission always succeeds.
            if kind is not None:
                kind, entry, shared_len = None, None, 0
            elif register and prefix % ps:
                register = False
            else:
                return False

        # -- the slot's page table ----------------------------------------
        pages = [0] * max(n_seq, 1)
        if kind is not None:
            if shared_pages:
                self._pool.retain(shared_pages)
            pages[:len(shared_pages)] = [int(x) for x in shared_pages]
            entry.last_used = self.vtime
            entry.hits += 1
            self.stats.prefix_hits += 1
            self.stats.prompt_tokens_reused += shared_len
            if kind == "exact" and entry.state is not None:
                self._insert(idx, entry.state)
            logits = entry.logits if (kind == "exact" and shared_len == p) else None
            absorbed = shared_len
        else:
            if prefix > 0:
                lg, small = self._prefill(req, prefix)
            else:
                lg, small = None, self._empty1
            fresh = [self._alloc_page() for _ in range(immediate)]
            pages[:len(fresh)] = fresh
            self._insert_paged(idx, small, fresh)
            if register:
                ent = PrefixEntry(length=prefix, pages=tuple(fresh),
                                  state=self._snapshot_rest(small), logits=lg.clone(),
                                  last_used=self.vtime)
                if self._radix.insert(tokens[:prefix], ent) and fresh:
                    self._pool.retain(fresh)
            logits = lg if prefix == p else None
            absorbed = prefix
            budget -= immediate

        slot.pages = pages
        slot.page_budget = budget
        if n_seq:
            self._pt_np[idx, :] = pages
            self.stats.pool_peak_pages = max(self.stats.pool_peak_pages,
                                             self._pool.pages_in_use)
        self._start_slot(idx, slot, req, absorbed, logits, replay, notify)
        return True

    def _paged_room(self, need_new: int, reserve_exclude=()) -> bool:
        """Best-effort admission control: can the pool cover ``need_new``
        future allocations on top of every active slot's outstanding budget?
        Free pages plus trie-only (evictable) pages count; pages the request
        is about to retain are excluded.  Conservative against generation
        worst cases but not a hard guarantee — an exhausted pool raises at
        allocation time."""
        free = self._pool.free_count
        hold: dict[int, int] = {}
        for _, e in self._radix.items() if self._radix is not None else ():
            for pg in e.pages:
                hold[pg] = hold.get(pg, 0) + 1
        excl = {int(x) for x in reserve_exclude}
        evictable = sum(1 for pg, c in hold.items()
                        if pg not in excl and self._pool.refs[pg] == c)
        outstanding = sum(s.page_budget for s in self._slots if s.state != FREE)
        return need_new + outstanding <= free + evictable

    def _alloc_page(self) -> int:
        pg = self._pool.alloc()
        while pg is None:
            if not self._evict_one():
                raise RuntimeError(
                    "kv page pool exhausted: every page is pinned by an "
                    "active slot (raise num_pages)")
            pg = self._pool.alloc()
        return pg

    def _evict_one(self) -> bool:
        """Drop the least-recently-used prefix entry, freeing its pages
        (those not also held by active slots)."""
        if self._radix is None or not len(self._radix):
            return False
        lru_toks, lru_used = None, None
        for toks, e in self._radix.items():
            if lru_used is None or e.last_used < lru_used:
                lru_toks, lru_used = toks, e.last_used
        entry = self._radix.remove(lru_toks)
        self._scrub_pages(self._pool.release(entry.pages))
        self.stats.prefix_evictions += 1
        return True

    def _ensure_writable_pages(self) -> None:
        """Pre-tick page-fault pass: every active slot's write position this
        tick must map a page this slot owns alone.  A null mapping is
        allocated; a shared one (refcount > 1) is copied on write."""
        ps = self._page_size
        for i, s in enumerate(self._slots):
            if s.state == FREE:
                continue
            pi = s.input_pos // ps
            phys = s.pages[pi]
            if phys == 0:
                new = self._alloc_page()
            elif self._pool.refs[phys] > 1:
                new = self._alloc_page()
                self._copy_page(phys, new)
                self._pool.release([phys])   # others still hold it: no free
                self.stats.cow_copies += 1
            else:
                continue
            s.pages[pi] = new
            self._pt_np[i, pi] = new
            s.page_budget = max(s.page_budget - 1, 0)
        self.stats.pool_peak_pages = max(self.stats.pool_peak_pages,
                                         self._pool.pages_in_use)

    # -- the decode tick --------------------------------------------------

    def step_decode(self) -> None:
        t0 = time.perf_counter()
        if self.fault_injector is not None:
            # an injected device loss lands here, mid-serving; the run loop
            # catches the WorkerFailure and calls recover()
            self.fault_injector.maybe_fail(self.stats.decode_steps)
        # free rows: token 0 at position 0 (a don't-care), or t = -1 under
        # the paged layout, which sends their writes to the null page
        self._tok_np[:] = 0
        self._t_np[:] = -1 if self._paged else 0
        self._temps_np[:] = 0
        self._uids_np[:] = 0
        self._ctr_np[:] = 0
        if self._forced is not None:
            self._forced_np[:] = False
        active = 0
        for i, s in enumerate(self._slots):
            if s.state == FREE:
                continue
            active += 1
            self._tok_np[i] = s.input_tok
            self._t_np[i] = s.input_pos
            self._temps_np[i] = s.req.temperature
            self._uids_np[i] = s.req.uid
            self._ctr_np[i] = len(s.out)
            if s.input_x is not None:
                self._forced_np[i] = True
                self._fx_np[i] = s.input_x
        if self._pages_per_seq:
            self._ensure_writable_pages()
        next_tok = self._run_step(sampling=bool((self._temps_np > 0).any()))
        self.stats.decode_seconds += time.perf_counter() - t0
        self.stats.decode_steps += 1
        self.stats.active_slot_steps += active
        self.vtime += 1
        for i, s in enumerate(self._slots):
            if s.state == PREFILL:
                if s.tail_idx < len(s.tail):
                    s.input_pos += 1
                    self._feed(s, s.tail[s.tail_idx])
                    s.tail_idx += 1
                else:
                    # the last prompt token went in this tick -> first sample
                    # (a replayed slot keeps its first token's time)
                    s.state = DECODE
                    s.input_x = None
                    if s.first_tok_vtime is None:
                        s.first_tok_vtime = self.vtime
                    self._deliver(i, int(next_tok[i]))
            elif s.state == DECODE:
                self._deliver(i, int(next_tok[i]))
        if self.telemetry is not None:
            self.telemetry.on_tick(self, active, time.perf_counter() - t0)

    def _deliver(self, idx: int, tok: int) -> None:
        s = self._slots[idx]
        s.out.append(tok)
        s.input_tok = tok
        s.input_pos = s.req.prompt_len + len(s.out) - 1
        self.stats.generated_tokens += 1
        if self.on_token is not None:
            self.on_token(s.req.uid, tok)
        if self._finished(s, tok):
            self._retire(idx)

    @staticmethod
    def _finished(s: _Slot, tok: int) -> bool:
        return (len(s.out) >= s.req.max_new_tokens
                or (s.req.eos_id is not None and tok == s.req.eos_id))

    def _retire(self, idx: int, preempted: bool = False) -> None:
        s = self._slots[idx]
        r = s.req
        result = RequestResult(
            uid=r.uid, tokens=np.asarray(s.out, np.int32), prompt_len=r.prompt_len,
            arrival=r.arrival, admit_vtime=s.admit_vtime,
            first_token_vtime=s.first_tok_vtime, finish_vtime=self.vtime,
            admitted_with_active=s.admitted_with_active, slo_steps=r.slo_steps,
            preempted=preempted)
        with self._lock:
            self._results[r.uid] = result
        if self._paged and s.pages is not None:
            held = [pg for pg in s.pages if pg]
            if held:
                self._scrub_pages(self._pool.release(held))
            if self._pt_np is not None:
                self._pt_np[idx, :] = 0
            s.pages = None
            s.page_budget = 0
        # a finished request's KV does not outlive it
        self._insert(idx, self._empty1)
        s.state = FREE
        s.req = None
        s.tail = None
        s.input_x = None
        if self.telemetry is not None:
            self.telemetry.on_finish(result, self)
        if self.on_finish is not None:
            self.on_finish(result)

    # -- introspection ----------------------------------------------------

    def layout_summary(self) -> list[dict]:
        """Ordered per-layer {layer, kind, layout}: the engine's resolved
        slot-state union over the whole stack."""
        return [{"layer": i, "kind": kind, "layout": spec.layout}
                for i, (kind, spec) in enumerate(zip(self.cfg.layer_kinds(),
                                                     self._layer_specs))]

    def pool_stats(self) -> dict:
        """Paged-pool occupancy snapshot (zeros for dense layouts).

        ``page_bytes`` is the per-page footprint summed across every paged
        layer arena; ``dense_equiv_bytes`` is what the same layers would pin
        under the per-slot full layout (max_slots x max_len rows)."""
        if not self._paged or self._pool is None:
            return {"layout": "dense", "page_size": 0, "num_pages": 0,
                    "pages_in_use": 0, "pages_peak": 0, "page_bytes": 0,
                    "bytes_in_use": 0, "bytes_peak": 0,
                    "dense_equiv_bytes": 0, "prefix_entries": 0}
        peak = max(self.stats.pool_peak_pages, self._pool.pages_in_use)
        return {
            "layout": "paged",
            "page_size": self._page_size,
            "num_pages": self._pool.num_pages,
            "pages_in_use": self._pool.pages_in_use,
            "pages_peak": peak,
            "page_bytes": self._page_bytes,
            "bytes_in_use": self._pool.pages_in_use * self._page_bytes,
            "bytes_peak": peak * self._page_bytes,
            "dense_equiv_bytes": (self.max_slots * self._pages_per_seq
                                  * self._page_bytes),
            "prefix_entries": len(self._radix) if self._radix else 0,
        }
