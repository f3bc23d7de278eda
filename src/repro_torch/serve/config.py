"""ServeConfig: the validated engine configuration of the port.

The JAX package's ``ServeConfig`` with its defaults and validation
messages.  ``kernel_mode`` takes every name and alias of the JAX package's
(kernels/ops.py ``KernelMode``) and is stored canonical; it defaults to
"auto", the kernels at their built-in launch configs.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from repro_torch.distributed.plan import Topology
from repro_torch.kernels.ops import KernelMode

__all__ = ["ServeConfig"]

_POLICIES = ("continuous", "wave")
_LAYOUTS = ("auto", "paged")
_SCHEDULERS = ("fifo", "deadline")


@dataclass(frozen=True)
class ServeConfig:
    """``max_slots`` decode rows; ``max_len`` bounds prompt + generation when
    a layer keeps a full cache; ``seed`` seeds the CLI's weights and prompts;
    ``aging_steps`` is the queue wait that decays a request's priority by one
    level (0 = strict priority).

    ``layout`` "auto" keeps per-slot caches (ring for LPSA/local layers,
    full otherwise); "paged" allocates would-be full caches as one shared
    refcounted page arena per layer with per-sequence page tables
    (kvcache.CacheSpec layout="paged").  ``num_pages`` 0 sizes the pool to
    the per-slot worst case (max_slots * max_len / page_size + the null
    page).  ``prefix_sharing`` turns on the radix-trie prompt-prefix index
    (paged layout only).  ``moe_expert_capacity`` > 0 bounds a MoE model's
    per-expert load a decode tick by deferring admissions (0 = unbounded;
    decode itself never drops a token).

    ``top_k`` restricts temperature sampling to the logits at least the
    k-th largest (0 = unrestricted); ``seed`` also seeds the sampling keys.
    ``policy`` "wave" degrades continuous batching to lock-step gang
    scheduling (admit only when every slot is free), the baseline.
    ``scheduler`` picks the admission order: "fifo" (aged
    priority-then-arrival) or "deadline" (earliest effective deadline first
    over ``Request.slo_steps``; a request without an SLO gets
    ``slo_default_steps`` plus an aging penalty per priority level).
    ``preemption`` (deadline scheduler only) lets the engine truncate and
    retire the youngest active slot that has blown its own deadline when the
    queue head would otherwise miss its SLO (``RequestResult.preempted``).

    ``topology`` (a ``distributed.plan.Topology``) serves SPMD: the engine
    is one rank of a dp x tp ``torch.distributed`` world and cuts its shard
    of the model; None serves on one device.

    ``kernel_mode``: "auto" (the kernels at their built-in launch configs;
    the plain versions on the CPU), "tuned" (each GEMM and attention shape
    takes the config the autotune cache holds: kernels/autotune.py), "ref"
    (the plain versions, CPU only), or any other name or alias of the JAX
    package's (kernels/ops.py maps each)."""
    max_slots: int = 4
    max_len: int = 512
    layout: str = "auto"
    page_size: int = 16
    num_pages: int = 0
    prefix_sharing: bool = True
    top_k: int = 0
    seed: int = 0
    policy: str = "continuous"
    moe_expert_capacity: int = 0
    scheduler: str = "fifo"
    aging_steps: int = 64
    slo_default_steps: int = 256
    preemption: bool = False
    topology: Topology | None = None
    kernel_mode: str = "auto"

    def __post_init__(self):
        if self.topology is not None and not isinstance(self.topology, Topology):
            raise ValueError(f"topology must be a distributed.plan.Topology "
                             f"or None, got {type(self.topology).__name__}")
        if self.max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {self.max_slots}")
        if self.max_len < 1:
            raise ValueError(f"max_len must be >= 1, got {self.max_len}")
        if self.policy not in _POLICIES:
            raise ValueError(f"unknown policy {self.policy!r}: valid "
                             f"policies are {', '.join(_POLICIES)}")
        if self.layout not in _LAYOUTS:
            raise ValueError(f"unknown layout {self.layout!r}: valid "
                             f"layouts are {', '.join(_LAYOUTS)}")
        if self.layout == "paged":
            if self.page_size < 1:
                raise ValueError(f"page_size must be >= 1, got "
                                 f"{self.page_size}")
            if self.max_len % self.page_size:
                raise ValueError(
                    f"max_len ({self.max_len}) must be a multiple of "
                    f"page_size ({self.page_size}) so logical pages tile "
                    f"the sequence exactly")
            if self.num_pages and self.num_pages < 2:
                raise ValueError("num_pages must be 0 (auto) or >= 2 "
                                 "(page 0 is the reserved null page)")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if self.moe_expert_capacity < 0:
            raise ValueError(f"moe_expert_capacity must be >= 0 "
                             f"(0 = unbounded), got "
                             f"{self.moe_expert_capacity}")
        if self.scheduler not in _SCHEDULERS:
            raise ValueError(f"unknown scheduler {self.scheduler!r}: valid "
                             f"schedulers are {', '.join(_SCHEDULERS)}")
        if self.aging_steps < 0:
            raise ValueError(f"aging_steps must be >= 0 (0 = strict "
                             f"priority), got {self.aging_steps}")
        if self.slo_default_steps < 1:
            raise ValueError(f"slo_default_steps must be >= 1, got "
                             f"{self.slo_default_steps}")
        if self.preemption and self.scheduler != "deadline":
            raise ValueError("preemption requires scheduler='deadline' "
                             "(only deadlines define an over-SLO budget)")
        # normalise via the enum (aliases accepted, unknowns raise)
        object.__setattr__(self, "kernel_mode", KernelMode.parse(self.kernel_mode).value)

    @property
    def pages_per_seq(self) -> int:
        return self.max_len // self.page_size if self.layout == "paged" else 0

    def resolved_num_pages(self) -> int:
        """Pool capacity incl. the null page (auto-sizing when num_pages=0)."""
        if self.layout != "paged":
            return 0
        if self.num_pages:
            return self.num_pages
        return self.max_slots * self.pages_per_seq + 1

    def with_updates(self, **kw) -> "ServeConfig":
        unknown = set(kw) - {f.name for f in dataclasses.fields(self)}
        if unknown:
            raise TypeError(f"unknown ServeConfig field(s): "
                            f"{', '.join(sorted(unknown))}")
        return dataclasses.replace(self, **kw)
