"""Ternary (1.58-bit) weight quantization used by the serving export, and
the int8 activation quantization of the MoE experts' inputs.

``Q_1.58(W)``: absmean scale gamma = mean(|W|) + eps, trits =
round_clip(W / gamma, -1, 1) (BitNet b1.58).  The arithmetic stays in W's
dtype as the JAX package does (the mean accumulates in float32 and is cast
back); round is half-to-even in both frameworks.

``Q_int8(x)``: per-token absmax, scale = amax / 127 + eps computed in x's
dtype and held in float32, values = round_clip(x / scale, -127, 127).
Forward only: the straight-through fake-quants for training wait for the
training slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["EPS", "TernaryWeight", "QuantizedActivation", "absmean_scale",
           "ternary_quantize", "int8_quantize", "int8_dequantize",
           "int8_fake_quant"]

EPS = 1e-6


class TernaryWeight(NamedTuple):
    values: torch.Tensor   # int8 in {-1, 0, 1}, the weight's shape
    scale: torch.Tensor    # float32 scalar


class QuantizedActivation(NamedTuple):
    values: torch.Tensor   # int8 in [-127, 127], the activation's shape
    scale: torch.Tensor    # float32, the quantized axis kept with size 1


def absmean_scale(w: torch.Tensor) -> torch.Tensor:
    """Per-tensor gamma = mean(|W|) + eps, in W's dtype."""
    return w.abs().mean(dtype=torch.float32).to(w.dtype) + EPS


def ternary_quantize(w: torch.Tensor) -> TernaryWeight:
    gamma = absmean_scale(w)
    q = torch.clamp(torch.round(w / gamma), -1.0, 1.0)
    return TernaryWeight(values=q.to(torch.int8), scale=gamma.float())


def int8_quantize(x: torch.Tensor, *, dim: int = -1) -> QuantizedActivation:
    """Per-token absmax int8 quantization of activations (the paper's Q_int8)."""
    amax = x.abs().amax(dim=dim, keepdim=True)
    scale = (amax / 127.0 + EPS).float()
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return QuantizedActivation(values=q, scale=scale)


def int8_dequantize(qa: QuantizedActivation, dtype=torch.float32) -> torch.Tensor:
    return qa.values.to(dtype) * qa.scale.to(dtype)


def int8_fake_quant(x: torch.Tensor) -> torch.Tensor:
    """x quantized to int8 and back, in x's dtype."""
    return int8_dequantize(int8_quantize(x), dtype=x.dtype)
