"""Ternary (1.58-bit) weight quantization, int8 activation quantization,
and their straight-through fake-quants for quantization-aware training.

``Q_1.58(W)``: absmean scale gamma = mean(|W|) + eps (per tensor, or per
output column with ``per_channel``), trits = round_clip(W / gamma, -1, 1)
(BitNet b1.58).  The arithmetic stays in W's dtype as the JAX package does
(the mean accumulates in float32 and is cast back); round is half-to-even in
both frameworks.

``Q_int8(x)``: per-token absmax, scale = amax / 127 + eps computed in x's
dtype and held in float32, values = round_clip(x / scale, -127, 127).

The fake-quants (``ternary_fake_quant``, ``int8_fake_quant``,
``ternary_fake_quant_stacked``) are ``torch.autograd.Function``s: forward
quantizes and dequantizes in the input's dtype, backward passes the
gradient through unchanged, as the JAX package's ``custom_vjp``s do.

On a tensor-parallel shard the per-tensor and per-token statistics are the
whole tensor's, given by the caller (``models.ternary_linear``): a weight
shard's absmean scale ``gamma`` (the sum of |W| over the ranks over the
whole count), a row-parallel input's ``amax`` (the max over the ranks:
exact).  The STE backward is the identity either way, so neither carries a
gradient.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["EPS", "TernaryWeight", "QuantizedActivation", "absmean_scale",
           "ternary_quantize", "ternary_dequantize", "ternary_fake_quant", "stacked_scale",
           "ternary_fake_quant_stacked", "int8_quantize", "int8_dequantize",
           "int8_fake_quant", "ternary_matmul_ref"]

EPS = 1e-6


class TernaryWeight(NamedTuple):
    values: torch.Tensor   # int8 in {-1, 0, 1}, the weight's shape
    scale: torch.Tensor    # float32, broadcastable to values


class QuantizedActivation(NamedTuple):
    values: torch.Tensor   # int8 in [-127, 127], the activation's shape
    scale: torch.Tensor    # float32, the quantized axis kept with size 1


def absmean_scale(w: torch.Tensor, *, per_channel: bool = False) -> torch.Tensor:
    """gamma = mean(|W|) + eps in W's dtype: per tensor, or with
    ``per_channel`` per output column of a (..., in, out) weight."""
    if per_channel:
        dims = tuple(range(w.ndim - 1))
        return w.abs().mean(dim=dims, keepdim=True, dtype=torch.float32).to(w.dtype) + EPS
    return w.abs().mean(dtype=torch.float32).to(w.dtype) + EPS


def ternary_quantize(w: torch.Tensor, *, per_channel: bool = False,
                     gamma: torch.Tensor | None = None) -> TernaryWeight:
    """W -> TernaryWeight, its scale ``absmean_scale(w)`` unless ``gamma``
    (in W's dtype) is given."""
    if gamma is None:
        gamma = absmean_scale(w, per_channel=per_channel)
    q = torch.clamp(torch.round(w / gamma), -1.0, 1.0)
    return TernaryWeight(values=q.to(torch.int8), scale=gamma.float())


def ternary_dequantize(tw: TernaryWeight, dtype=torch.float32) -> torch.Tensor:
    return tw.values.to(dtype) * tw.scale.to(dtype)


def int8_quantize(x: torch.Tensor, *, dim: int = -1,
                  amax: torch.Tensor | None = None) -> QuantizedActivation:
    """Per-token absmax int8 quantization of activations (the paper's
    Q_int8); ``amax`` (x's dtype, ``dim`` kept) replaces x's own."""
    if amax is None:
        amax = x.abs().amax(dim=dim, keepdim=True)
    scale = (amax / 127.0 + EPS).float()
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return QuantizedActivation(values=q, scale=scale)


def int8_dequantize(qa: QuantizedActivation, dtype=torch.float32) -> torch.Tensor:
    return qa.values.to(dtype) * qa.scale.to(dtype)


class _TernaryFakeQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, gamma):
        return ternary_dequantize(ternary_quantize(w, gamma=gamma), dtype=w.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Int8FakeQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, amax):
        qa = int8_quantize(x) if amax is None else int8_quantize(x, amax=amax)
        return int8_dequantize(qa, dtype=x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


def stacked_scale(w: torch.Tensor) -> torch.Tensor:
    """The absmean scale of each slab of a stacked weight's leading (expert)
    axis, (E, 1, ..., 1) in w's dtype: the float32 mean of |w| over the
    slab, cast, + EPS."""
    dims = tuple(range(1, w.ndim))
    return w.abs().mean(dim=dims, keepdim=True, dtype=torch.float32).to(w.dtype) + EPS


class _TernaryFakeQuantStacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w):
        gamma = stacked_scale(w)
        q = torch.clamp(torch.round(w / gamma), -1.0, 1.0)
        return (q * gamma).to(w.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


def ternary_fake_quant(w: torch.Tensor, gamma: torch.Tensor | None = None) -> torch.Tensor:
    """STE ternary fake-quant (QAT): forward dequantize(quantize(w)) in w's
    dtype with a per-tensor scale (``gamma`` where given: a shard's, the
    whole weight's), backward the identity."""
    return _TernaryFakeQuant.apply(w, gamma)


def int8_fake_quant(x: torch.Tensor, amax: torch.Tensor | None = None) -> torch.Tensor:
    """STE int8 fake-quant: x quantized per token and back, in x's dtype,
    from its own absmax or ``amax`` (a row-parallel shard's, over the whole
    row); backward the identity."""
    return _Int8FakeQuant.apply(x, amax)


def ternary_fake_quant_stacked(w: torch.Tensor) -> torch.Tensor:
    """STE ternary fake-quant with one absmean scale per slab of the leading
    (expert) axis; backward the identity."""
    return _TernaryFakeQuantStacked.apply(w)


def ternary_matmul_ref(x: torch.Tensor, tw_values: torch.Tensor, tw_scale: torch.Tensor,
                       out_dtype=torch.float32) -> torch.Tensor:
    """x @ (values * scale), computed in ``out_dtype``."""
    w = tw_values.to(out_dtype) * tw_scale.to(out_dtype)
    return torch.matmul(x.to(out_dtype), w)
