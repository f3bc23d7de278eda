"""Shared model layers: RMSNorm, RoPE, tied-embedding logits, soft-cap.

Plain functions on tensors, with ``RMSNorm`` as the module that holds a
norm's ``scale`` buffer (zero-initialised: the norm scales by 1 + scale).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

__all__ = ["torch_dtype", "RMSNorm", "rmsnorm", "softcap", "rope",
           "apply_rope", "logits_from_embed"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's ``dtype`` string."""
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; have {sorted(_DTYPES)}")
    return _DTYPES[name]


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


def logits_from_embed(embed: torch.Tensor, x: torch.Tensor,
                      cap: float | None = None) -> torch.Tensor:
    """Tied-embedding logits: x @ embed^T in x's dtype, then float32."""
    return softcap((x @ embed.to(x.dtype).T).float(), cap)
