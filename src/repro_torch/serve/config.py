"""ServeConfig: the validated engine configuration of the port.

The fields the dense/ring serving path reads, with the JAX package's
defaults.  The paged layout, top-k, policies, schedulers and topology of the
JAX ``ServeConfig`` wait for later slices (ROADMAP).
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["ServeConfig"]


@dataclass(frozen=True)
class ServeConfig:
    """``max_slots`` decode rows; ``max_len`` bounds prompt + generation when
    a layer keeps a full cache; ``seed`` seeds the CLI's weights and prompts;
    ``aging_steps`` is the queue wait that decays a request's priority by one
    level (0 = strict priority)."""
    max_slots: int = 4
    max_len: int = 512
    seed: int = 0
    aging_steps: int = 64

    def __post_init__(self):
        if self.max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {self.max_slots}")
        if self.max_len < 1:
            raise ValueError(f"max_len must be >= 1, got {self.max_len}")
        if self.aging_steps < 0:
            raise ValueError(f"aging_steps must be >= 0 (0 = strict "
                             f"priority), got {self.aging_steps}")
