"""GQA attention with ternary projections: streaming (LPSA) prefill, full
prefill and one-token decode, all through the ``sparse_attention`` kernel;
and the training pass over master weights (``attn_train``), whose attention
is ``flash_masked``: the JAX package's chunked flash attention, plain
PyTorch under autograd.

Layer kinds: "attn" — global attention, sink + window under LPSA or full
causal; "local" — sliding window (sink 0, window ``cfg.window``).  Tensor
layout at these functions is the JAX package's: (B, L, H, D).  Under the
"tuned" kernel mode (kernels/ops.py) each attention call takes the config
the autotune cache holds for its shape: the kernel, or ``flash_masked`` at
a tuned kv chunk (kernels/autotune.py ``run_attention``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core import lpsa as lpsa_lib
from repro_torch.kernels import autotune, ops
from repro_torch.models import kvcache as KV
from repro_torch.models import layers as L
from repro_torch.models.ternary_linear import (TernaryLinear, tlin_norm_input, tlin_train,
                                               tlin_train_input)

__all__ = ["FULL_SINK", "NEG_INF", "Attention", "kind_sink_window", "qkv_project",
           "attn_prefill_streaming", "attn_prefill_full", "DecodeStep",
           "decode_step_inputs", "attn_decode", "flash_masked", "attn_train"]

FULL_SINK = 1 << 30   # a sink beyond any position == full causal attention
NEG_INF = -1e30


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, qd, kvd, tc = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.ternary
        self.wq = TernaryLinear(d, qd, tc, device)
        self.wk = TernaryLinear(d, kvd, tc, device)
        self.wv = TernaryLinear(d, kvd, tc, device)
        self.wo = TernaryLinear(qd, d, tc, device)


def kind_sink_window(cfg: ModelConfig, kind: str, serve_sparse: bool) -> tuple[int, int]:
    """(sink, window) of a layer kind; serve_sparse turns LPSA on for globals."""
    if kind == "local":
        return 0, cfg.window
    if cfg.lpsa is not None and serve_sparse:
        return cfg.lpsa.sink, cfg.lpsa.window
    return FULL_SINK, 0


def qkv_project(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                norm_scale: torch.Tensor):
    """Residual (B, L, D) -> q (B, L, Hq, Dh), k/v (B, L, Hkv, Dh) of
    ``rmsnorm(norm_scale, x)``; one DAS step, with the norm inside it, feeds
    all three projections."""
    b, l, _ = x.shape
    xin, ca = tlin_norm_input(x, norm_scale, cfg.ternary)
    hd = cfg.head_dim_
    return (p.wq(xin, ca).reshape(b, l, cfg.n_heads, hd),
            p.wk(xin, ca).reshape(b, l, cfg.n_kv_heads, hd),
            p.wv(xin, ca).reshape(b, l, cfg.n_kv_heads, hd))


def _attend(q, k, v, q_pos, k_pos, *, sink: int, window: int,
            softcap: float | None = None, round_scores: bool = False) -> torch.Tensor:
    """``ops.sparse_attention``, or under the "tuned" kernel mode the
    config the autotune cache holds for the shape."""
    if ops.current_dispatch().mode == "tuned":
        return autotune.run_attention(q, k, v, q_pos, k_pos, sink=sink, window=window,
                                      softcap=softcap, round_scores=round_scores)
    return ops.sparse_attention(q, k, v, q_pos, k_pos, sink=sink, window=window,
                                softcap=softcap, round_scores=round_scores)


def _rope_fn(cfg: ModelConfig):
    def f(x, pos):
        cos, sin = L.rope(pos, cfg.head_dim_, cfg.rope_theta)
        return L.apply_rope(x, cos, sin)
    return f


def attn_prefill_streaming(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                           norm_scale: torch.Tensor, kind: str):
    """LPSA Algorithm-1 prefill of the residual x normed by ``norm_scale``
    -> (y (B, L, D), stream state for the ring).  Each pack is normed with
    its projections' DAS step.

    The packs attend with their scores rounded to x's dtype before the
    scale, as the JAX package's streaming prefill always attends
    (core/lpsa.py ``_softmax_attend``, whatever its kernel mode); the
    full-cache prefill and decode keep float32 scores, as its
    ``flash_masked`` and decode attention do."""
    sink, window = kind_sink_window(cfg, kind, True)
    if sink >= FULL_SINK:
        raise ValueError("streaming prefill needs a sparse pattern (lpsa/local)")
    spec = lpsa_lib.LpsaSpec(sink=sink, window=window,
                             chunk=cfg.lpsa.chunk if cfg.lpsa else 256)
    o, state = lpsa_lib.lpsa_prefill(
        x, lambda pack: qkv_project(p, cfg, pack, norm_scale), spec=spec,
        num_q_heads=cfg.n_heads, num_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim_, rope=_rope_fn(cfg), softcap=cfg.attn_softcap,
        attend=functools.partial(_attend, round_scores=True))
    b, l = x.shape[0], x.shape[1]
    return p.wo(o.reshape(b, l, cfg.q_dim)), state


def attn_prefill_full(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                      norm_scale: torch.Tensor, max_len: int):
    """Full causal prefill of the residual x normed by ``norm_scale`` -> (y
    (B, L, D), a full cache of max_len slots)."""
    b, l, _ = x.shape
    q, k, v = qkv_project(p, cfg, x, norm_scale)
    pos = torch.arange(l, device=x.device)
    rp = _rope_fn(cfg)
    q, k = rp(q, pos), rp(k, pos)
    pos_b = pos.to(torch.int32)[None].expand(b, l).contiguous()
    o = _attend(q, k, v, pos_b, pos_b, sink=FULL_SINK, window=0, softcap=cfg.attn_softcap)
    cache = KV.init_cache(cfg, KV.CacheSpec("full", b, max_len=max_len,
                                            dtype=x.dtype), x.device)
    cache["k"][:, :l] = k
    cache["v"][:, :l] = v
    cache["pos"][:, :l] = pos_b
    return p.wo(o.reshape(b, l, cfg.q_dim)), cache


class DecodeStep(NamedTuple):
    """What every layer of one decode step shares (decode_step_inputs)."""
    t: torch.Tensor        # (B,) int64 absolute positions
    q_pos: torch.Tensor    # (B, 1) int32 query positions for the kernel
    rows: torch.Tensor     # (B,) int64 batch rows
    rope_cs: tuple         # RoPE cos, sin (B, 1, Dh/2)
    slots: dict            # layer kind -> (B,) cache slot of position t
    page_table: torch.Tensor | None = None   # (B, pages_per_seq) int32 of
                                             # the paged arenas


def decode_step_inputs(cfg: ModelConfig, t: torch.Tensor, kinds,
                       serve_sparse: bool,
                       page_table: torch.Tensor | None = None) -> DecodeStep:
    """Positions, RoPE tables and cache slots of one decode step at positions
    t (B,), computed once for all layers of ``kinds``; ``page_table``
    addresses the paged arenas (ignored by the other layouts)."""
    t = t.to(torch.int64)
    slots = {}
    for kind in set(kinds):
        sink, window = kind_sink_window(cfg, kind, serve_sparse)
        slots[kind] = KV.write_slot(t, sink=sink, window=window,
                                    ring=sink < FULL_SINK)
    return DecodeStep(t, t.to(torch.int32)[:, None],
                      torch.arange(t.shape[0], device=t.device),
                      L.rope(t[:, None], cfg.head_dim_, cfg.rope_theta), slots,
                      page_table)


def attn_decode(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                norm_scale: torch.Tensor, cache: dict, step: DecodeStep, kind: str, *,
                serve_sparse: bool = True):
    """One-token decode of the residual x (B, 1, D) normed by ``norm_scale``,
    at the positions of ``step``; the cache is updated in place.  A paged
    arena is written and read through ``step.page_table``; its inactive rows
    carry t = -1.  Returns y (B, 1, D)."""
    b = x.shape[0]
    sink, window = kind_sink_window(cfg, kind, serve_sparse)
    q, k, v = qkv_project(p, cfg, x, norm_scale)
    q, k = L.apply_rope(q, *step.rope_cs), L.apply_rope(k, *step.rope_cs)
    KV.attn_write(cache, k, v, step.q_pos[:, 0], step.slots[kind], step.rows,
                  step.page_table)
    k_all, v_all, k_pos = KV.attn_read(cache, step.page_table)
    o = _attend(q, k_all, v_all, step.q_pos, k_pos, sink=sink, window=window,
                softcap=cfg.attn_softcap)
    return p.wo(o.reshape(b, 1, cfg.q_dim))


def flash_masked(q, k, v, q_pos, k_pos, *, sink: int, window: int,
                 softcap: float | None = None, kv_chunk: int = 512) -> torch.Tensor:
    """Differentiable chunked attention with the LPSA mask family, the JAX
    package's ``flash_masked``: keys in chunks of ``kv_chunk`` (one chunk
    when it does not divide Lk), an online softmax in float32, GQA by
    repeating each kv head over its query heads, the soft-cap on the scaled
    scores, keys at negative positions empty.  q (B, Lq, Hq, D); k, v (B,
    Lk, Hkv, D); positions (Lq,) / (Lk,) or per sequence (B, Lq) / (B, Lk).
    Rows with no allowed key give 0.  Returns (B, Lq, Hq, D) in q's dtype.
    The kv heads are repeated by a broadcast, whose backward is a sum (the
    backward of ``repeat_interleave`` adds with atomics on the card, in no
    fixed order).  Its forward runs in a profiler range "flash_masked"."""
    with torch.profiler.record_function("flash_masked"):
        return _flash_masked(q, k, v, q_pos, k_pos, sink, window, softcap, kv_chunk)


def _flash_masked(q, k, v, q_pos, k_pos, sink, window, softcap, kv_chunk):
    b, lq, hq, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    n_rep = hq // hkv
    c = min(kv_chunk, lk)
    if lk % c:
        c = lk
    scale = d ** -0.5
    q_pos = torch.broadcast_to(torch.atleast_2d(q_pos), (b, lq))
    k_pos = torch.broadcast_to(torch.atleast_2d(k_pos), (b, lk))
    qh = q.transpose(1, 2).float()                                  # (B, Hq, Lq, D)
    f32 = dict(dtype=torch.float32, device=q.device)
    m = torch.full((b, hq, lq, 1), NEG_INF, **f32)
    l = torch.zeros((b, hq, lq, 1), **f32)
    acc = torch.zeros((b, hq, lq, d), **f32)

    def heads(t):          # (B, c, Hkv, D) -> (B, Hq, c, D) float32, kv head h // n_rep
        t = t.transpose(1, 2).float()
        if n_rep == 1:
            return t
        return t[:, :, None].expand(b, hkv, n_rep, *t.shape[2:]).reshape(b, hq, *t.shape[2:])

    for j in range(0, lk, c):
        kb, vb = heads(k[:, j:j + c]), heads(v[:, j:j + c])
        kp = k_pos[:, j:j + c]
        s = torch.matmul(qh, kb.transpose(-1, -2)) * scale
        if softcap is not None:
            s = torch.tanh(s / softcap) * softcap
        mask = lpsa_lib.lpsa_allowed(q_pos[:, :, None], kp[:, None, :], sink, window)
        mask = (mask & (kp >= 0)[:, None, :])[:, None]             # (B, 1, Lq, c)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        m_safe = torch.where(m_new <= NEG_INF, 0.0, m_new)
        p = torch.where(mask, torch.exp(s - m_safe), 0.0)
        alpha = torch.where(m <= NEG_INF, 0.0, torch.exp(m - m_safe))
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p, vb)
        m = m_new
    out = acc / torch.where(l == 0.0, 1.0, l)
    return out.transpose(1, 2).to(q.dtype)


def attn_train(p: dict, cfg: ModelConfig, x: torch.Tensor, kind: str, rt) -> torch.Tensor:
    """Training attention over whole sequences x (B, L, D), already normed,
    on master weights {wq, wk, wv, wo}: q/k/v take one DAS step and one
    int8 fake-quant of x, RoPE at positions 0..L-1, ``flash_masked`` with
    the layer kind's sink and window (LPSA on global layers when
    ``rt.serve_sparse``), then wo.  On a head shard (``rt.model_mesh``;
    ``cfg`` with the rank's head counts) wo is row-parallel: its input's
    int8 scale comes over "model" and the float32 partial is returned, for
    the block to sum."""
    b, l, _ = x.shape
    tc, hd, mesh = cfg.ternary, cfg.head_dim_, rt.model_mesh
    sink, window = kind_sink_window(cfg, kind, rt.serve_sparse)
    xq = tlin_train_input(x, tc)
    q = tlin_train(p["wq"], xq, tc).reshape(b, l, cfg.n_heads, hd)
    k = tlin_train(p["wk"], xq, tc).reshape(b, l, cfg.n_kv_heads, hd)
    v = tlin_train(p["wv"], xq, tc).reshape(b, l, cfg.n_kv_heads, hd)
    pos = torch.arange(l, device=x.device)
    rp = _rope_fn(cfg)
    q, k = rp(q, pos), rp(k, pos)
    o = flash_masked(q, k, v, pos, pos, sink=sink, window=window, softcap=cfg.attn_softcap)
    o = o.reshape(b, l, cfg.q_dim)
    return tlin_train(p["wo"], tlin_train_input(o, tc, mesh), tc, partial=mesh is not None)
