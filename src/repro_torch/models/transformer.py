"""Decoder blocks and the layer-stack loops.

An "attn" or "local" ``Block`` is rmsnorm -> attention -> residual ->
rmsnorm -> FFN -> residual, the FFN gated (silu or tanh-gelu, by
``cfg.act``), the 2-matrix MLP (``ffn_kind="mlp"``, musicgen-medium) or,
for a MoE config, the mixture of experts (models/moe.py);
with DAS on, each rmsnorm runs inside the DAS step of the projections it
feeds (``tlin_norm_input``, and the MoE's one ``das_topk`` call).  A "gla"
block swaps the attention for gated linear attention (models/gla.py, its
norm inside the q/k/v/g DAS step too); an "rwkv" block is the time-mix and
the channel-mix (models/rwkv6.py), each after its rmsnorm, with no FFN; a
"mamba" block is its rmsnorm and the Mamba2 mixer (models/mamba2.py), with
no FFN either.  Their caches are recurrent slot states, written in place.
A config with ``shared_attn`` (zamba2) has one attention module, owned by
the model and passed to every attention block, each of which keeps its own
norms and FFN.  The JAX package scans stacked layer groups; here the stack
is a loop over the model's ``ModuleList``, whatever the pattern and its
tail (gemma3's 26 layers = 4 x 6 + 2).

Training runs on master-weight trees in the JAX package's layout (plain
dicts of tensors, ``models.model.init_params``), on one device or on a
rank's tensor-parallel shard (``Runtime.mesh``; ``models.model.loss_fn``
cuts the config to the rank's heads): each block half takes its normed
input through ``copy_to_model`` (the gradient summed over "model") and
sums the row-parallel shard's float32 partial with ``reduce_from_model``
before the cast; under remat the recompute replays the forward's
collectives, in one order on every rank.  ``block_train`` is any
block over whole sequences, in the JAX package's order: an "attn" / "local"
block (its own attention or zamba2's shared one, whose gradient autograd
sums over every position that runs it), then its FFN or MoE
(``moe.moe_train``); a "gla" block (``gla.gla_train``) and its FFN or MoE;
an "rwkv" block, the time-mix then the channel-mix, each after its rmsnorm
(``rwkv6.time_mix_train``, ``channel_mix_train``); a "mamba" block
(``mamba2.mamba_train``).  ``stack_train`` runs the scan-stacked groups (a
leading group axis on every leaf) and then the tail, each group or tail
layer under ``torch.utils.checkpoint`` when ``cfg.remat`` (non-reentrant:
the forward is run again in the backward).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import copy_to_model, reduce_from_model
from repro_torch.models import attention as A
from repro_torch.models import gla as G
from repro_torch.models import kvcache as KV
from repro_torch.models import mamba2 as M
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv6 as R
from repro_torch.models.layers import ACT, RMSNorm, rmsnorm
from repro_torch.models.ternary_linear import (TernaryLinear, tlin_norm_input,
                                               tlin_train, tlin_train_input)
from repro_torch.tree import leaves, tree_map

__all__ = ["ATTN_KINDS", "RECURRENT_KINDS", "FFN_KINDS", "FFN", "Block", "ffn_apply", "block_prefill",
           "block_decode", "layer_cache_spec", "stack_prefill", "stack_decode",
           "Runtime", "ffn_train", "block_train", "stack_train"]

ATTN_KINDS = ("attn", "local")
RECURRENT_KINDS = ("mamba", "rwkv", "gla")   # the recurrent kinds the port serves


FFN_KINDS = ("gated", "mlp")


@dataclass(frozen=True)
class Runtime:
    """What the training pass runs on: ``serve_sparse`` puts LPSA on the
    global layers, as the JAX package's ``Runtime`` does by default; under a
    ``mesh`` (a ``distributed.plan.Mesh``) the rank's shard, its batch rows
    split over ``dp_axes`` ("pod", "data"; ``Topology.dp_axes_for``).  On a
    mesh with ``experts_only`` the "model" axis cuts a MoE's experts alone
    and every other leaf is whole on each rank (the JAX dry run's
    ``dpattn``)."""
    serve_sparse: bool = True
    mesh: Any = None
    dp_axes: tuple = ("data",)

    @property
    def expert_mesh(self):
        """The mesh where its "model" axis cuts the experts, else None."""
        return self.mesh if self.mesh is not None and self.mesh.size("model") > 1 else None

    @property
    def model_mesh(self):
        """The mesh where its "model" axis cuts the dense weights, else None."""
        mesh = self.expert_mesh
        return None if mesh is None or mesh.experts_only else mesh


class FFN(nn.Module):
    """Gated FFN, w_out(act(w_gate x) * w_in x), or with ``ffn_kind="mlp"``
    the 2-matrix MLP, w_out(act(w_in x)); act = silu or gelu."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.ffn_kind not in FFN_KINDS or cfg.act not in ACT:
            raise NotImplementedError(
                f"ffn_kind {cfg.ffn_kind!r}, act {cfg.act!r}: the port serves "
                f"ffn_kind {FFN_KINDS} with {sorted(ACT)}")
        d, f, tc = cfg.d_model, cfg.d_ff, cfg.ternary
        if cfg.ffn_kind == "gated":
            self.w_gate = TernaryLinear(d, f, tc, device)
        self.w_in = TernaryLinear(d, f, tc, device)
        self.w_out = TernaryLinear(f, d, tc, device)


class Block(nn.Module):
    """One block of ``kind``; ``experts`` (e0, e1) builds a MoE block with
    those experts' stacks only (expert parallelism)."""

    def __init__(self, cfg: ModelConfig, kind: str, dtype: torch.dtype,
                 device=None, experts: tuple[int, int] | None = None):
        super().__init__()
        if kind not in ATTN_KINDS + RECURRENT_KINDS:
            raise NotImplementedError(
                f"layer kind {kind!r}: the port serves {ATTN_KINDS + RECURRENT_KINDS} blocks")
        self.kind = kind
        self.norm1 = RMSNorm(cfg.d_model, dtype, device)
        if kind == "mamba":
            self.mamba = M.Mamba2(cfg, dtype, device)
            return
        if kind == "rwkv":
            self.rwkv = R.RWKV(cfg, dtype, device)
        elif kind == "gla":
            self.gla = G.GLA(cfg, dtype, device)
        elif not cfg.shared_attn:   # else the model's one shared attention
            self.attn = A.Attention(cfg, device)
        self.norm2 = RMSNorm(cfg.d_model, dtype, device)
        if kind == "rwkv":
            return
        if cfg.moe is not None:
            self.moe = MOE.MoE(cfg, dtype, device, experts)
        else:
            self.ffn = FFN(cfg, device)


def ffn_apply(p: FFN, cfg: ModelConfig, x: torch.Tensor,
              norm_scale: torch.Tensor) -> torch.Tensor:
    """The FFN of the residual x normed by ``norm_scale``: gate and up (or
    the MLP's w_in alone) take one DAS step, with the norm inside it."""
    xin, ca = tlin_norm_input(x, norm_scale, cfg.ternary)
    act = ACT[cfg.act]
    if cfg.ffn_kind == "mlp":
        h = act(p.w_in(xin, ca))
    else:
        h = act(p.w_gate(xin, ca)) * p.w_in(xin, ca)
    return p.w_out(h)


def _mixer_ffn(bp: Block, cfg: ModelConfig, x: torch.Tensor, decode: bool) -> torch.Tensor:
    """The FFN or MoE half of a block on the residual x.  A decode step
    gives the MoE the no-drop capacity (a hot expert must never drop a live
    request's token); a prefill runs it over the whole prefix at once, with
    the capacity-factor bound of all its tokens, as the JAX package does."""
    if cfg.moe is not None:
        cap = MOE.decode_capacity(cfg, x.shape[0] * x.shape[1]) if decode else None
        return MOE.moe_apply(bp.moe, cfg, x, bp.norm2.scale, capacity=cap)
    return ffn_apply(bp.ffn, cfg, x, bp.norm2.scale)


def _rwkv_prefill(bp: Block, cfg: ModelConfig, x: torch.Tensor):
    """The rwkv block over a prompt: time-mix, then channel-mix, each after
    its rmsnorm -> (x, {"wkv", "shift_t", "shift_c"})."""
    y_t, state = R.time_mix(bp.rwkv, cfg, rmsnorm(bp.norm1.scale, x))
    x = x + y_t
    y_c, state["shift_c"] = R.channel_mix(bp.rwkv, rmsnorm(bp.norm2.scale, x))
    return x + y_c, state


def _attn(bp: Block, shared: A.Attention | None) -> A.Attention:
    """The block's attention, or the model's shared one."""
    return bp.attn if hasattr(bp, "attn") else shared


def block_prefill(bp: Block, cfg: ModelConfig, x: torch.Tensor, *,
                  serve_sparse: bool, max_len: int, shared: A.Attention | None = None):
    """-> (x, cache) with the cache ready for decode at position L;
    ``shared`` is the model's shared attention (``cfg.shared_attn``)."""
    if bp.kind == "mamba":
        y, cache = M.mamba_prefill(bp.mamba, cfg, x, bp.norm1.scale)
        return x + y, cache
    if bp.kind == "rwkv":
        return _rwkv_prefill(bp, cfg, x)
    if bp.kind == "gla":
        y, cache = G.gla_prefill(bp.gla, cfg, x, bp.norm1.scale)
        x = x + y
        return x + _mixer_ffn(bp, cfg, x, decode=False), cache
    sink, window = A.kind_sink_window(cfg, bp.kind, serve_sparse)
    attn = _attn(bp, shared)
    if sink < A.FULL_SINK:
        y, state = A.attn_prefill_streaming(attn, cfg, x, bp.norm1.scale, bp.kind)
        cache = KV.ring_from_stream(cfg, state, sink=sink, window=window)
    else:
        y, cache = A.attn_prefill_full(attn, cfg, x, bp.norm1.scale, max_len)
    x = x + y
    return x + _mixer_ffn(bp, cfg, x, decode=False), cache


def block_decode(bp: Block, cfg: ModelConfig, x: torch.Tensor, cache: dict,
                 step: A.DecodeStep | None, ssd: M.SsdStep | None = None, *,
                 serve_sparse: bool, shared: A.Attention | None = None) -> torch.Tensor:
    """One token per sequence at the positions of ``step`` (None for a
    stack without attention) and, for a mamba block, of ``ssd`` (its
    buffer rows; rwkv and gla take no position); the cache updates in
    place."""
    if bp.kind == "mamba":
        return x + M.mamba_decode(bp.mamba, cfg, x, bp.norm1.scale, cache, ssd)
    if bp.kind == "rwkv":
        x = x + R.time_mix_step(bp.rwkv, cfg, rmsnorm(bp.norm1.scale, x), cache)
        return x + R.channel_mix_step(bp.rwkv, rmsnorm(bp.norm2.scale, x), cache)
    if bp.kind == "gla":
        x = x + G.gla_decode(bp.gla, cfg, x, bp.norm1.scale, cache)
        return x + _mixer_ffn(bp, cfg, x, decode=True)
    x = x + A.attn_decode(_attn(bp, shared), cfg, x, bp.norm1.scale, cache, step, bp.kind,
                          serve_sparse=serve_sparse)
    return x + _mixer_ffn(bp, cfg, x, decode=True)


def layer_cache_spec(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     dtype: torch.dtype, *, serve_sparse: bool, page_size: int = 0,
                     num_pages: int = 0) -> KV.CacheSpec:
    """A layer kind's serving cache; ``page_size > 0`` turns a would-be full
    cache into a paged arena (ring caches and recurrent states are already
    O(1) a slot)."""
    if kind in RECURRENT_KINDS:
        return KV.CacheSpec(kind, batch)
    sink, window = A.kind_sink_window(cfg, kind, serve_sparse)
    if sink < A.FULL_SINK:
        return KV.CacheSpec("ring", batch, sink=sink, window=window, dtype=dtype)
    if page_size > 0:
        return KV.CacheSpec("paged", batch, max_len=max_len, page_size=page_size,
                            num_pages=num_pages, dtype=dtype)
    return KV.CacheSpec("full", batch, max_len=max_len, dtype=dtype)


def stack_prefill(layers: nn.ModuleList, cfg: ModelConfig, x: torch.Tensor, *,
                  serve_sparse: bool, max_len: int, shared: A.Attention | None = None):
    caches = []
    for bp in layers:
        x, c = block_prefill(bp, cfg, x, serve_sparse=serve_sparse,
                             max_len=max_len, shared=shared)
        caches.append(c)
    return x, caches


def stack_decode(layers: nn.ModuleList, cfg: ModelConfig, x: torch.Tensor,
                 caches: list, t: torch.Tensor, *, serve_sparse: bool,
                 page_table: torch.Tensor | None = None,
                 shared: A.Attention | None = None) -> torch.Tensor:
    kinds = [bp.kind for bp in layers if bp.kind in ATTN_KINDS]
    step = (A.decode_step_inputs(cfg, t, kinds, serve_sparse, page_table)
            if kinds else None)
    ssd = (M.ssd_step_inputs(cfg, t) if any(bp.kind == "mamba" for bp in layers)
           else None)
    for bp, c in zip(layers, caches):
        x = block_decode(bp, cfg, x, c, step, ssd, serve_sparse=serve_sparse, shared=shared)
    return x


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

def ffn_train(p: dict, cfg: ModelConfig, x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The FFN on master weights over the normed x: gate and up share one
    DAS step and fake-quant of x (the MLP's w_in takes it alone), the down
    projection its own of h.  With ``mesh`` (a d_ff shard) the down is
    row-parallel and its float32 partial is returned."""
    act, tc = ACT[cfg.act], cfg.ternary
    xq = tlin_train_input(x, tc)
    if "w_gate" in p:
        h = act(tlin_train(p["w_gate"], xq, tc)) * tlin_train(p["w_in"], xq, tc)
    else:
        h = act(tlin_train(p["w_in"], xq, tc))
    return tlin_train(p["w_out"], tlin_train_input(h, tc, mesh), tc, partial=mesh is not None)


def _mixer_ffn_train(bp: dict, cfg: ModelConfig, x: torch.Tensor, rt: Runtime) -> torch.Tensor:
    """The FFN or MoE half of an attention or gla block on the normed x
    (on a "model" shard: the rank's float32 partial; the MoE's experts are
    the rank's)."""
    if cfg.moe is not None:
        return MOE.moe_train(bp["moe"], cfg, x, rt.expert_mesh)
    return ffn_train(bp["ffn"], cfg, x, rt.model_mesh)


def _half(f, x: torch.Tensor, normed: torch.Tensor, mesh) -> torch.Tensor:
    """x + f(normed), ``f`` a block half: on a tensor-parallel shard its
    input through ``copy_to_model`` and its float32 partial summed over
    "model" before the cast."""
    if mesh is None:
        return x + f(normed)
    return x + reduce_from_model(f(copy_to_model(normed, mesh)), mesh).to(x.dtype)


def block_train(bp: dict, cfg: ModelConfig, x: torch.Tensor, kind: str, shared,
                rt: Runtime) -> torch.Tensor:
    """One block of any kind over whole sequences on master weights, each
    mixer and FFN after its rmsnorm, each added to the residual."""
    n1 = bp["norm1"]["scale"]
    if kind == "mamba":
        return x + M.mamba_train(bp["mamba"], cfg, rmsnorm(n1, x))
    if kind == "rwkv":
        x = x + R.time_mix_train(bp["rwkv"], cfg, rmsnorm(n1, x))
        return x + R.channel_mix_train(bp["rwkv"], cfg, rmsnorm(bp["norm2"]["scale"], x))
    mesh = rt.model_mesh
    if kind == "gla":
        x = x + G.gla_train(bp["gla"], cfg, rmsnorm(n1, x))
    elif kind in ATTN_KINDS:
        ap = bp["attn"] if "attn" in bp else shared
        x = _half(lambda h: A.attn_train(ap, cfg, h, kind, rt), x, rmsnorm(n1, x), mesh)
    else:
        raise ValueError(f"unknown layer kind {kind!r}")
    return _half(lambda h: _mixer_ffn_train(bp, cfg, h, rt), x,
                 rmsnorm(bp["norm2"]["scale"], x),
                 rt.expert_mesh if cfg.moe is not None else mesh)


def stack_train(layers: dict, cfg: ModelConfig, x: torch.Tensor, rt: Runtime) -> torch.Tensor:
    """The layers {stacked, tail, shared} over x: the stacked groups first
    (group g runs the pattern's blocks on leaf slices [g]), then the tail;
    with ``cfg.remat``, each group and each tail layer is recomputed in the
    backward."""
    pat, shared = cfg.layer_pattern, layers.get("shared")

    def run(f, x):
        return checkpoint(f, x, use_reentrant=False) if cfg.remat else f(x)

    stacked = layers.get("stacked")
    if stacked is not None:
        for g in range(leaves(stacked[0])[0].shape[0]):
            gp = tuple(tree_map(lambda a, g=g: a[g], t) for t in stacked)

            def group(x_, gp=gp):
                for j, kind in enumerate(pat):
                    x_ = block_train(gp[j], cfg, x_, kind, shared, rt)
                return x_
            x = run(group, x)
    kinds = cfg.layer_kinds()
    start = cfg.n_layers - len(layers["tail"])
    for i, bp in enumerate(layers["tail"]):
        x = run(lambda x_, bp=bp, kind=kinds[start + i]:
                block_train(bp, cfg, x_, kind, shared, rt), x)
    return x
