"""Ternary (1.58-bit) weight quantization used by the serving export.

``Q_1.58(W)``: absmean scale gamma = mean(|W|) + eps, trits =
round_clip(W / gamma, -1, 1) (BitNet b1.58).  The arithmetic stays in W's
dtype as the JAX package does (the mean accumulates in float32 and is cast
back); round is half-to-even in both frameworks.  The straight-through
fake-quant for training waits for the training slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["EPS", "TernaryWeight", "absmean_scale", "ternary_quantize"]

EPS = 1e-6


class TernaryWeight(NamedTuple):
    values: torch.Tensor   # int8 in {-1, 0, 1}, the weight's shape
    scale: torch.Tensor    # float32 scalar


def absmean_scale(w: torch.Tensor) -> torch.Tensor:
    """Per-tensor gamma = mean(|W|) + eps, in W's dtype."""
    return w.abs().mean(dtype=torch.float32).to(w.dtype) + EPS


def ternary_quantize(w: torch.Tensor) -> TernaryWeight:
    gamma = absmean_scale(w)
    q = torch.clamp(torch.round(w / gamma), -1.0, 1.0)
    return TernaryWeight(values=q.to(torch.int8), scale=gamma.float())
