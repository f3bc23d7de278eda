"""GLA, the gated linear attention block (paper Sec. V-D, ref [61]).

q/k/v/g ternary projections, a low-rank data-dependent forget gate
log alpha_t = log_sigmoid(x Wa1 Wa2) / TAU per key dim, the chunked linear
attention shared with RWKV6, the head norm and the output gate.  Ternary
and DAS apply to every projection: the paper's GLA + TQ + DAS configuration
(Table III).  q, k, v and g share one DAS step with the block's rmsnorm
inside it, as attention's q/k/v do; the gate LoRA takes the normed rows
from the same ``das_topk`` call (``with_normed``).  The decode step writes
the slot state ``s`` in place.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (GroupNorm, full_f32, group_norm, log_sigmoid,
                                       rmsnorm, silu)
from repro_torch.models.linear_attn import CHUNK, chunked_linear_attn, linear_attn_step
from repro_torch.models.ternary_linear import TernaryLinear, tlin_init, tlin_train, tlin_train_input

__all__ = ["GATE_LORA", "TAU", "GLA", "gla_init", "gla_prefill", "gla_decode", "gla_train"]

GATE_LORA = 16
TAU = 16.0


class GLA(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device=None):
        super().__init__()
        d, tc = cfg.d_model, cfg.ternary
        hd = cfg.n_heads * cfg.head_dim_
        for name in ("wq", "wk", "wv", "wg"):
            setattr(self, name, TernaryLinear(d, hd, tc, device))
        self.register_buffer("wa1", torch.zeros((d, GATE_LORA), dtype=dtype, device=device))
        self.register_buffer("wa2", torch.zeros((GATE_LORA, hd), dtype=dtype, device=device))
        self.ln_x = GroupNorm(hd, dtype, device)
        self.wo = TernaryLinear(hd, d, tc, device)


def gla_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> dict:
    """Master weights in the JAX package's tree layout, drawn from ``gen`` in
    a fixed order."""
    d, dev = cfg.d_model, gen.device
    hd = cfg.n_heads * cfg.head_dim_
    p = {name: tlin_init(gen, d, hd, dtype) for name in ("wq", "wk", "wv", "wg")}
    p["wa1"] = (torch.randn((d, GATE_LORA), generator=gen, device=dev) * d ** -0.5).to(dtype)
    p["wa2"] = (torch.randn((GATE_LORA, hd), generator=gen, device=dev)
                * GATE_LORA ** -0.5).to(dtype)
    p["ln_x"] = {"scale": torch.ones(hd, dtype=dtype, device=dev),
                 "bias": torch.zeros(hd, dtype=dtype, device=dev)}
    p["wo"] = tlin_init(gen, hd, d, dtype, scale=(hd * 2 * cfg.n_layers) ** -0.5)
    return p


def _proj(p: GLA, cfg: ModelConfig, x: torch.Tensor, norm_scale: torch.Tensor):
    """The residual x (B, L, D) -> q, k, v, log alpha (B, L, H, hd) and g
    (B, L, H*hd) of ``rmsnorm(norm_scale, x)``."""
    b, l, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim_
    das = cfg.ternary.das
    if das is None:
        xin = normed = rmsnorm(norm_scale, x)
        ca = None
    else:
        ca = ops.das_topk(x, keep=das.keep, block=das.block, norm_scale=norm_scale,
                          with_mask=False, with_normed=True)
        xin, normed = x, ca.normed
    q = p.wq(xin, ca).reshape(b, l, h, hd)
    k = p.wk(xin, ca).reshape(b, l, h, hd)
    v = p.wv(xin, ca).reshape(b, l, h, hd)
    g = p.wg(xin, ca)
    return q, k, v, g, _log_decay(p.wa1, p.wa2, normed).reshape(b, l, h, hd)


def _log_decay(wa1: torch.Tensor, wa2: torch.Tensor, normed: torch.Tensor) -> torch.Tensor:
    """log alpha = log_sigmoid(x Wa1 Wa2) / TAU of the normed rows, float32
    with TF32 off -> (B*L, H*hd)."""
    with full_f32():
        return log_sigmoid(normed.reshape(-1, normed.shape[-1]).float() @ wa1.float()
                           @ wa2.float()) / TAU


def _gated(ln: dict, cfg: ModelConfig, o: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """What wo takes: the head norm of o (B, L, H, hd) in g's dtype times
    silu(g)."""
    b, l = o.shape[0], o.shape[1]
    return group_norm(ln["scale"], ln["bias"], o.reshape(b, l, -1), cfg.n_heads,
                      g.dtype) * silu(g)


def _out(p: GLA, cfg: ModelConfig, o: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return p.wo(_gated({"scale": p.ln_x.scale, "bias": p.ln_x.bias}, cfg, o, g))


def gla_prefill(p: GLA, cfg: ModelConfig, x: torch.Tensor, norm_scale: torch.Tensor):
    """The mixer over a prompt from the zero state: the residual x normed by
    ``norm_scale`` -> (y (B, L, D), {"s": final state float32})."""
    q, k, v, g, la = _proj(p, cfg, x, norm_scale)
    o, s_fin = chunked_linear_attn(q, k, v, la, chunk=CHUNK, mode="gla")
    return _out(p, cfg, o, g), {"s": s_fin}


def gla_decode(p: GLA, cfg: ModelConfig, x: torch.Tensor, norm_scale: torch.Tensor,
               state: dict) -> torch.Tensor:
    """One token per row, x (B, 1, D); ``state["s"]`` is overwritten in place."""
    q, k, v, g, la = _proj(p, cfg, x, norm_scale)
    o, s_new = linear_attn_step(q[:, 0], k[:, 0], v[:, 0], la[:, 0], state["s"], mode="gla")
    state["s"].copy_(s_new)
    return _out(p, cfg, o[:, None], g)


def gla_train(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The mixer over whole sequences on master weights ``p`` (the JAX
    package's tree), x (B, L, D) already normed -> y (B, L, D)."""
    b, l, _ = x.shape
    h, hd, tc = cfg.n_heads, cfg.head_dim_, cfg.ternary
    xq = tlin_train_input(x, tc)
    q, k, v = (tlin_train(p[n], xq, tc).reshape(b, l, h, hd) for n in ("wq", "wk", "wv"))
    g = tlin_train(p["wg"], xq, tc)
    la = _log_decay(p["wa1"], p["wa2"], x).reshape(b, l, h, hd)
    o, _ = chunked_linear_attn(q, k, v, la, chunk=CHUNK, mode="gla")
    return tlin_train(p["wo"], tlin_train_input(_gated(p["ln_x"], cfg, o, g), tc), tc)
