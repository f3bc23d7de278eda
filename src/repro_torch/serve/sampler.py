"""Next-token sampling: greedy.

Temperature and top-k sampling wait for a later slice (ROADMAP): matching
the JAX engine's tokens needs its threefry ``fold_in`` + ``categorical``.
"""

from __future__ import annotations

import torch

__all__ = ["greedy"]


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """(..., V) -> (...,) int64: the first index of the largest logit, as
    ``jnp.argmax`` picks."""
    return torch.argmax(logits, dim=-1)
