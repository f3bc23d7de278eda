"""RWKV6 "Finch" block: time-mix with a data-dependent per-channel decay,
then the channel-mix FFN; every projection a ternary linear.

The JAX package's simplified Finch: the token shift mixes with learned
static coefficients, and the decay LoRA w_t = exp(-exp(w0 + tanh(x Wd1)
Wd2)) is the data-dependent part.  The module's buffers are named as the
JAX tree's leaves.  The token-shift mixes, relu(k)^2 and sigmoid(r) * kv
round in x's dtype op by op, as the reference does; the decay LoRA runs in
float32 with TF32 off.  Each of the 8 projections takes its own DAS step
(the mixes come after the rmsnorm, so no norm folds into ``das_topk``).
The step forms write the slot states ``wkv``, ``shift_t`` and ``shift_c``
in place: the engine's CUDA graph holds their storage.

``time_mix_train`` and ``channel_mix_train`` are the training passes over
whole sequences on a master tree (the JAX package's ``rwkv_time_mix`` and
``rwkv_channel_mix`` from a zero past): the same code as the prefill, each
projection taking its input's DAS mask and int8 fake-quant
(``tlin_train_input``) and the STE ternary fake-quant of its master weight.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import GroupNorm, full_f32, group_norm, sigmoid, silu
from repro_torch.models.linear_attn import CHUNK, chunked_linear_attn, linear_attn_step
from repro_torch.models.ternary_linear import TernaryLinear, tlin_init, tlin_train, tlin_train_input

__all__ = ["DECAY_LORA", "RWKV", "rwkv_init", "time_mix", "channel_mix",
           "time_mix_step", "channel_mix_step", "time_mix_train", "channel_mix_train"]

DECAY_LORA = 64


class RWKV(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device=None):
        super().__init__()
        d, f, tc = cfg.d_model, cfg.d_ff, cfg.ternary
        hd = cfg.n_heads * cfg.head_dim_
        for name in ("wr", "wk", "wv", "wg"):
            setattr(self, name, TernaryLinear(d, hd, tc, device))
        self.wo = TernaryLinear(hd, d, tc, device)
        self.ck = TernaryLinear(d, f, tc, device)
        self.cv = TernaryLinear(f, d, tc, device)
        self.cr = TernaryLinear(d, d, tc, device)

        def buf(name, shape):
            self.register_buffer(name, torch.zeros(shape, dtype=dtype, device=device))

        buf("w_decay1", (d, DECAY_LORA))
        buf("w_decay2", (DECAY_LORA, hd))
        buf("w0", (hd,))
        buf("u", (cfg.n_heads, cfg.head_dim_))
        buf("mix_t", (4, d))
        buf("mix_c", (2, d))
        self.ln_x = GroupNorm(hd, dtype, device)


def rwkv_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> dict:
    """Master weights in the JAX package's tree layout, drawn from ``gen`` in
    a fixed order (the constants as the JAX package sets them)."""
    d, f, dev = cfg.d_model, cfg.d_ff, gen.device
    h, hd = cfg.n_heads, cfg.head_dim_
    out_scale = (h * hd * 2 * cfg.n_layers) ** -0.5

    def dense(d_in, d_out, scale=None):
        s = scale if scale is not None else d_in ** -0.5
        return (torch.randn((d_in, d_out), generator=gen, device=dev) * s).to(dtype)

    p = {name: tlin_init(gen, d, h * hd, dtype) for name in ("wr", "wk", "wv", "wg")}
    p["wo"] = tlin_init(gen, h * hd, d, dtype, scale=out_scale)
    p["w_decay1"] = dense(d, DECAY_LORA)
    p["w_decay2"] = dense(DECAY_LORA, h * hd, 0.1)
    p["w0"] = torch.full((h * hd,), -2.0, dtype=dtype, device=dev)
    p["u"] = (torch.randn((h, hd), generator=gen, device=dev) * 0.1).to(dtype)
    p["mix_t"] = torch.full((4, d), 0.5, dtype=dtype, device=dev)
    p["ln_x"] = {"scale": torch.ones(h * hd, dtype=dtype, device=dev),
                 "bias": torch.zeros(h * hd, dtype=dtype, device=dev)}
    p["ck"] = tlin_init(gen, d, f, dtype)
    p["cv"] = tlin_init(gen, f, d, dtype, scale=(f * 2 * cfg.n_layers) ** -0.5)
    p["cr"] = tlin_init(gen, d, d, dtype)
    p["mix_c"] = torch.full((2, d), 0.5, dtype=dtype, device=dev)
    return p


def _shift(x: torch.Tensor, prev: torch.Tensor | None) -> torch.Tensor:
    """The x_{t-1} stream: zeros (or the carried ``prev``) at t = 0."""
    first = torch.zeros_like(x[:, :1]) if prev is None else prev.to(x.dtype)
    return torch.cat([first, x[:, :-1]], dim=1)


def _mix(x: torch.Tensor, x_prev: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """x * m + x_prev * (1 - m), each op rounded to x's dtype."""
    return x * m + x_prev * (1 - m)


def _decay_log(w1: torch.Tensor, w2: torch.Tensor, w0: torch.Tensor,
               xr: torch.Tensor) -> torch.Tensor:
    """log w_t = -exp(clip(w0 + tanh(x Wd1) Wd2, -8, 4)) in float32 (<= 0);
    the clip as ``jnp.clip`` computes it, max then min, so a tie splits its
    gradient as the JAX package's does (``torch.clamp`` passes it whole)."""
    with full_f32():
        lora = torch.tanh(xr.float() @ w1.float())
        lw = w0.float() + lora @ w2.float()
    lo, hi = (torch.full((), v, device=lw.device) for v in (-8.0, 4.0))
    return -torch.exp(torch.minimum(torch.maximum(lw, lo), hi))


def _serve_lin(p: RWKV):
    """name, x -> the module's ternary linear ``name`` of x."""
    return lambda name, x: getattr(p, name)(x)


def _train_lin(p: dict, tc):
    """name, x -> x DAS-masked and int8 fake-quantized, times the STE
    ternary fake-quant of the master weight ``name``."""
    return lambda name, x: tlin_train(p[name], tlin_train_input(x, tc), tc)


def _time_mix_proj(lin, p, cfg: ModelConfig, x: torch.Tensor, x_prev: torch.Tensor):
    """r, k, v, log w (B, L, H, hd) and g (B, L, H*hd) of the four token-shift
    mixes, each through its own projection (``lin``); ``p`` holds the mixes
    and the decay LoRA (the master tree, or a module's ``_leaves``)."""
    b, l, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim_
    mix = p["mix_t"].to(x.dtype)
    xr, xk, xv, xg = (_mix(x, x_prev, mix[i]) for i in range(4))
    r = lin("wr", xr).reshape(b, l, h, hd)
    k = lin("wk", xk).reshape(b, l, h, hd)
    v = lin("wv", xv).reshape(b, l, h, hd)
    g = lin("wg", xg)
    la = _decay_log(p["w_decay1"], p["w_decay2"], p["w0"], xr)
    return r, k, v, g, la.reshape(b, l, h, hd)


def _time_mix_out(lin, p, cfg: ModelConfig, o: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    b, l = o.shape[0], o.shape[1]
    o = group_norm(p["ln_x"]["scale"], p["ln_x"]["bias"], o.reshape(b, l, -1), cfg.n_heads,
                   o.dtype)
    return lin("wo", o * silu(g))


def _channel_mix(lin, mix_c: torch.Tensor, x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    mix = mix_c.to(x.dtype)
    k = lin("ck", _mix(x, x_prev, mix[0]))
    kv = lin("cv", torch.square(torch.relu(k)))
    r = lin("cr", _mix(x, x_prev, mix[1]))
    return sigmoid(r) * kv


def _leaves(p: RWKV) -> dict:
    """The module's mixes, LoRA and head norm as the master tree names them."""
    return {"mix_t": p.mix_t, "w_decay1": p.w_decay1, "w_decay2": p.w_decay2, "w0": p.w0,
            "ln_x": {"scale": p.ln_x.scale, "bias": p.ln_x.bias}}


def time_mix(p: RWKV, cfg: ModelConfig, x: torch.Tensor):
    """Time-mix over a prompt from the zero state.  x (B, L, D), normed.
    Returns (y, {"wkv", "shift_t"}), the states float32."""
    lin, leaves = _serve_lin(p), _leaves(p)
    r, k, v, g, la = _time_mix_proj(lin, leaves, cfg, x, _shift(x, None))
    o, s_fin = chunked_linear_attn(r, k, v, la, chunk=CHUNK, mode="rwkv", u=p.u)
    return (_time_mix_out(lin, leaves, cfg, o, g),
            {"wkv": s_fin, "shift_t": x[:, -1:].float().clone()})


def channel_mix(p: RWKV, x: torch.Tensor):
    """Channel-mix over a prompt.  Returns (y, shift_c (B, 1, D) float32)."""
    return _channel_mix(_serve_lin(p), p.mix_c, x, _shift(x, None)), x[:, -1:].float().clone()


def time_mix_step(p: RWKV, cfg: ModelConfig, x: torch.Tensor, state: dict) -> torch.Tensor:
    """One-token time-mix, x (B, 1, D); ``state``'s ``wkv`` and ``shift_t``
    are read, then overwritten in place."""
    lin, leaves = _serve_lin(p), _leaves(p)
    r, k, v, g, la = _time_mix_proj(lin, leaves, cfg, x, state["shift_t"].to(x.dtype))
    o, s_new = linear_attn_step(r[:, 0], k[:, 0], v[:, 0], la[:, 0], state["wkv"],
                                mode="rwkv", u=p.u)
    state["wkv"].copy_(s_new)
    state["shift_t"].copy_(x)
    return _time_mix_out(lin, leaves, cfg, o[:, None], g)


def channel_mix_step(p: RWKV, x: torch.Tensor, state: dict) -> torch.Tensor:
    """One-token channel-mix; ``state["shift_c"]`` is read, then
    overwritten in place."""
    y = _channel_mix(_serve_lin(p), p.mix_c, x, state["shift_c"].to(x.dtype))
    state["shift_c"].copy_(x)
    return y


def time_mix_train(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The time-mix over whole sequences on master weights ``p`` (the JAX
    package's tree), x (B, L, D) normed, the token shift from a zero past:
    r, k, v and g each take their own DAS mask and int8 fake-quant."""
    lin = _train_lin(p, cfg.ternary)
    r, k, v, g, la = _time_mix_proj(lin, p, cfg, x, _shift(x, None))
    o, _ = chunked_linear_attn(r, k, v, la, chunk=CHUNK, mode="rwkv", u=p["u"])
    return _time_mix_out(lin, p, cfg, o, g)


def channel_mix_train(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The channel-mix over whole sequences on master weights, x normed."""
    return _channel_mix(_train_lin(p, cfg.ternary), p["mix_c"], x, _shift(x, None))
