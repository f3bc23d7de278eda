"""Shared model layers: RMSNorm, the group norm over heads, RoPE,
activations, embeddings, logits, soft-cap, full-precision float32 matmuls.

Plain functions on tensors, with ``RMSNorm`` as the module that holds a
norm's ``scale`` buffer (zero-initialised: the norm scales by 1 + scale) and
``GroupNorm`` the one that holds the head norm's ``scale`` and ``bias``.
The activations and the embedding scale round where the JAX package's do,
step by step in x's dtype, so a bfloat16 model is bitwise the reference's.
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.distributed.collectives import reduce_from_model

__all__ = ["torch_dtype", "full_f32", "RMSNorm", "rmsnorm", "GroupNorm", "group_norm",
           "softcap", "rope", "apply_rope", "sigmoid", "silu", "gelu", "softplus", "log_sigmoid",
           "ACT", "xla_cumsum", "take_embed", "take_embed_shard", "scale_embed",
           "logits_from_embed"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's ``dtype`` string."""
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; have {sorted(_DTYPES)}")
    return _DTYPES[name]


@contextlib.contextmanager
def full_f32():
    """float32 matmuls in full precision (TF32 off) inside the block,
    whatever the global flag says: the JAX package's float32 products are
    float32 (the MoE router, the linear attention and its LoRAs)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.register_buffer("scale", torch.zeros(d, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(self.scale, x)


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) in float32, scaled by (1 + scale), cast
    back to x's dtype."""
    y = F.rms_norm(x.float(), (x.shape[-1],), eps=eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


class GroupNorm(nn.Module):
    """The head norm of the linear-attention blocks: ``scale`` (ones) and
    ``bias`` (zeros) over the d = heads x head_dim output lanes."""

    def __init__(self, d: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.register_buffer("scale", torch.ones(d, dtype=dtype, device=device))
        self.register_buffer("bias", torch.zeros(d, dtype=dtype, device=device))


def group_norm(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor, n_heads: int,
               out_dtype: torch.dtype, eps: float = 1e-5) -> torch.Tensor:
    """x (B, L, H*hd) normed per head in float32 with the biased variance
    (``jnp.var``; torch.var's default is the unbiased one), then y * scale
    + bias (not the rmsnorm's 1 + scale), cast to ``out_dtype``."""
    b, l, d = x.shape
    xh = x.reshape(b, l, n_heads, d // n_heads).float()
    mu = xh.mean(-1, keepdim=True)
    var = xh.var(-1, keepdim=True, correction=0)
    y = ((xh - mu) * torch.rsqrt(var + eps)).reshape(b, l, d)
    return (y * scale.float() + bias.float()).to(out_dtype)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


def rope(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables (..., head_dim/2) for absolute positions (...,)."""
    half = head_dim // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=positions.device) / half)
    ang = positions.float()[..., None] * freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate split halves.  x (..., L, H, D); cos/sin (..., L, D/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c, s = cos[..., None, :], sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def _const(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float: a bfloat16 tensor
    times it rounds once, as the JAX package's product with a constant of
    x's dtype does, and a CUDA graph capture copies nothing for it."""
    return torch.tensor(value, dtype=dtype).item()


class _Sigmoid(torch.autograd.Function):
    """1 / (1 + exp(-x)) step by step; backward g * (s * (1 - s)), the
    JAX package's derivative of ``jax.nn.sigmoid`` (autograd through the
    formula multiplies s^2 by exp(-x), which overflows to inf * 0 = nan
    below x = -88 in float32 and bfloat16)."""

    @staticmethod
    def forward(ctx, x):
        s = torch.reciprocal(1 + torch.exp(-x))
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        (s,) = ctx.saved_tensors
        return g * (s * (1 - s))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-x)) with every step rounded to x's dtype: the formula
    that XLA lowers ``jax.nn.sigmoid`` to (``torch.sigmoid`` rounds once,
    and differs from it in ~1.7 % of bfloat16 values).  All bfloat16 values
    agree but -87.5, -88 and -88.5, where XLA's exp overflows and the port's
    reciprocal gives a subnormal.  Its gradient is ``_Sigmoid``'s."""
    return _Sigmoid.apply(x)


def silu(g: torch.Tensor) -> torch.Tensor:
    """g * sigmoid(g), every step rounded to g's dtype: the formula that
    XLA lowers the JAX package's ``jax.nn.silu`` to, so a bfloat16 model
    rounds where the reference rounds (``F.silu`` rounds once, and differs
    from it in over a third of bfloat16 values)."""
    return g * sigmoid(g)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh GELU in ``jax.nn.gelu(x, approximate=True)``'s operation
    order, every step rounded to x's dtype, its constants first:
    x * (0.5 * (1 + tanh(c * (x + 0.044715 * x^3)))), c = sqrt(2/pi).
    ``F.gelu(approximate="tanh")`` differs from it in over a third of
    bfloat16 values."""
    c, a = _const((2 / math.pi) ** 0.5, x.dtype), _const(0.044715, x.dtype)
    cube = x * (x * x)
    return x * (0.5 * (1 + torch.tanh(c * (x + a * cube))))


class _Softplus(torch.autograd.Function):
    """max(x, 0) + log1p(exp(-|x|)); backward g * exp(x - softplus(x)),
    the derivative ``jnp.logaddexp`` defines (0.5 at x = 0, where autograd
    through max and |x| gives 1)."""

    @staticmethod
    def forward(ctx, x):
        out = torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g * torch.exp(x - out)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``'s formula: logaddexp(x, 0) = max(x, 0) +
    log1p(exp(-|x|)), and its derivative.  ``F.softplus`` is another
    float32 formula (up to ~1e-6 away)."""
    return _Softplus.apply(x)


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``'s formula: -softplus(-x).  ``F.logsigmoid`` is
    another float32 formula."""
    return -softplus(-x)


ACT = {"silu": silu, "gelu": gelu}

XLA_SCAN_BLOCK = 16


def _running_sums(x: torch.Tensor) -> torch.Tensor:
    """Inclusive sums along dim -2 of x (..., 16, m), added one term at a
    time from the first.  On the card ``torch.cumsum`` over a dim that is not
    the last adds exactly so (one thread a column, a float32 accumulator);
    on the CPU it accumulates in float64, so there the loop is written out."""
    if x.is_cuda and x.numel() > x.shape[-2]:
        return torch.cumsum(x, dim=-2)
    out = x.clone()
    for j in range(1, x.shape[-2]):
        out[..., j, :] += out[..., j - 1, :]
    return out


def xla_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.cumsum(x, axis=dim)`` in the order XLA computes it: the
    running sums inside blocks of 16 terms, the same scan over the blocks'
    totals (recursively), and each block's exclusive prefix added to its
    running sums.  Bitwise ``jnp.cumsum`` on the CPU in float32;
    ``torch.cumsum`` differs from it in about half the values at length
    256."""
    dim = dim % x.ndim
    n = x.shape[dim]
    pre, post = x.shape[:dim], x.shape[dim + 1:]
    y = x.reshape(math.prod(pre), n, math.prod(post))
    nb = -(-n // XLA_SCAN_BLOCK)
    if nb > 1 and nb * XLA_SCAN_BLOCK != n:
        y = F.pad(y, (0, 0, 0, nb * XLA_SCAN_BLOCK - n))
    if nb == 1:
        return _running_sums(y).reshape(x.shape)
    r = _running_sums(y.reshape(y.shape[0], nb, XLA_SCAN_BLOCK, y.shape[-1]))
    tot = xla_cumsum(r[:, :, -1], 1)
    r[:, 1:] += tot[:, :-1, None]
    return r.reshape(y.shape)[:, :n].reshape(x.shape)


def take_embed(embed: torch.Tensor, tokens: torch.Tensor, *,
               scale: bool = False) -> torch.Tensor:
    """Rows of ``embed`` for ``tokens``; ``scale`` multiplies them by
    sqrt(d) rounded to their dtype (gemma's input scaling: 48.0 at d = 2304
    and 34.0 at d = 1152 in bfloat16).  ``F.embedding``: its backward sums
    a row's gradients in a fixed order on the card, where indexing's
    backward may add with atomics."""
    x = F.embedding(tokens, embed)
    return scale_embed(x) if scale else x


def take_embed_shard(embed: torch.Tensor, tokens: torch.Tensor, lo: int, mesh, *,
                     scale: bool = False) -> torch.Tensor:
    """``take_embed`` on a vocab shard: ``embed`` holds rows [lo, lo + n) of
    the vocab; a token outside them gives a zero row, and the rows are
    summed over the mesh's "model" axis in float32 (exact: one contributor
    an element).  Backward, each rank's gradient reaches its own rows only,
    through ``F.embedding`` (no atomics)."""
    inside = (tokens >= lo) & (tokens < lo + embed.shape[0])
    rows = F.embedding(torch.where(inside, tokens - lo, 0), embed) * inside[..., None]
    x = reduce_from_model(rows.float(), mesh).to(embed.dtype)
    return scale_embed(x) if scale else x


def scale_embed(x: torch.Tensor) -> torch.Tensor:
    """Embedding rows times sqrt(d) rounded to their dtype (gemma's)."""
    return x * _const(x.shape[-1] ** 0.5, x.dtype)


def logits_from_embed(embed: torch.Tensor, x: torch.Tensor,
                      cap: float | None = None) -> torch.Tensor:
    """Tied-embedding logits: x @ embed^T in x's dtype, then float32."""
    return softcap((x @ embed.to(x.dtype).T).float(), cap)
