"""ServeConfig: the validated engine configuration of the port.

The fields the dense/ring and paged serving paths and the MoE admission
bound read, with the JAX package's defaults and validation messages.  Top-k, policies, schedulers and
topology of the JAX ``ServeConfig`` wait for later slices (ROADMAP).
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["ServeConfig"]

_LAYOUTS = ("auto", "paged")


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
    decode itself never drops a token)."""
    max_slots: int = 4
    max_len: int = 512
    layout: str = "auto"
    page_size: int = 16
    num_pages: int = 0
    prefix_sharing: bool = True
    seed: int = 0
    moe_expert_capacity: int = 0
    aging_steps: int = 64

    def __post_init__(self):
        if self.max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {self.max_slots}")
        if self.max_len < 1:
            raise ValueError(f"max_len must be >= 1, got {self.max_len}")
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
        if self.moe_expert_capacity < 0:
            raise ValueError(f"moe_expert_capacity must be >= 0 "
                             f"(0 = unbounded), got "
                             f"{self.moe_expert_capacity}")
        if self.aging_steps < 0:
            raise ValueError(f"aging_steps must be >= 0 (0 = strict "
                             f"priority), got {self.aging_steps}")

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
