"""Mixture-of-Experts FFN with ternary experts: the JAX package's
``models/moe.py`` without a mesh.

Routing: a float32 router (TF32 off: a routing decision is a
discontinuity), softmax, top-k, the gates renormalised over the k chosen.
Dispatch: a stable argsort of the routed copies gives each its rank in its
expert (the GShard/Switch recipe without the O(T*E*C) one-hot); a copy whose
rank is not below the capacity is dropped, and the kept copies are scattered
into an (E*C + 1, D) buffer whose last row takes the drops.  The experts run
as three batched matrix products over that buffer, silu(x Wg) * (x Wi) Wo,
on the whole dequantised stack of every expert (each packed stack unpacked
by one ``twd_decode`` launch, ``ops.twd_decode_stack``); each kept copy is
weighted by its gate and the k copies of a token are summed in routing
order.  The experts' input is the normed rows, DAS-masked (dense, not
compacted) and int8 fake-quantised; one ``das_topk`` call gives the normed
rows (the router's input), the masked rows and, for the shared expert, the
compaction.

Every step is free of host syncs and of data-dependent shapes, so the
engine's CUDA graph captures the decode step whole: expert loads are counted
with ``scatter_add_`` (``bincount`` sizes its output from the data), and the
combine adds a token's k contributions one after another onto zeros (no
atomics, so the sum does not depend on the batch).

``moe_train`` is the training pass on a master tree, through the same
``route`` and ``dispatch_compute``: the dispatch and the combine are
gathers through the slot <-> copy maps whose backward is the inverse
gather (a token's k copies summed in routing order, a dropped copy's
gradient exactly zero), so no gradient is summed with atomics and a
resumed run stays bitwise.

Expert parallelism, the JAX package's mesh branch: a MoE built with
``experts=(e0, e1)`` holds the stacks of experts [e0, e1) only (the
experts shard on a Topology's "model" axis).  Every rank routes its tokens
over all experts with the replicated router, runs ``dispatch_compute`` over
its own experts (the copies routed elsewhere go to the dump row, as drops
do), and the partial combines are summed over "model" in float32; the
shared expert follows the column / row rules of the dense linears.  The
capacity comes from the rank's own tokens, as the JAX package's
``t_local = (b // dp) * s``.  ``moe_train`` trains under the same
cut: each rank's float32 partial summed over "model" by the block, the
router's gradient summed over "model" (``copy_to_model``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, TernaryConfig
from repro_torch.core import ternary as tq
from repro_torch.core import twd
from repro_torch.distributed import collectives
from repro_torch.kernels import ops
from repro_torch.models.layers import full_f32, rmsnorm, silu
from repro_torch.models.ternary_linear import (ROW_ALIGN, TernaryLinear, check_format,
                                               export_tlin, tlin_init, tlin_train,
                                               tlin_train_input)

__all__ = ["EXPERT_STACKS", "SHARED", "ExpertStack", "MoE", "moe_init", "export_moe",
           "pack_stack", "expert_weights", "Route", "top_k_experts", "route",
           "dispatch_compute", "shared_ffn",
           "decode_capacity", "prefill_capacity", "moe_apply", "moe_train"]

EXPERT_STACKS = ("experts_gate", "experts_in", "experts_out")
SHARED = ("shared_gate", "shared_in", "shared_out")


class ExpertStack(nn.Module):
    """Serving form of one expert weight stack, logically (E, d_in, d_out):
    ``packed`` (E, R, d_out) uint8, each expert packed alone along d_in, or
    ``trits`` (E, d_in, d_out) int8, by the config's serve format, and the
    per-expert float32 ``scale`` (E, 1, 1)."""

    def __init__(self, n_experts: int, d_in: int, d_out: int, tc: TernaryConfig,
                 device=None):
        super().__init__()
        check_format(tc)
        self.d_in, self.d_out = d_in, d_out
        self.is_packed = tc.serve_format == "packed"
        if self.is_packed:
            rows = twd.packed_rows(d_in, ROW_ALIGN)
            self.register_buffer("packed", torch.zeros((n_experts, rows, d_out),
                                                       dtype=torch.uint8, device=device))
        else:
            self.register_buffer("trits", torch.zeros((n_experts, d_in, d_out),
                                                      dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.ones((n_experts, 1, 1), dtype=torch.float32,
                                                 device=device))

    def trits_of(self) -> torch.Tensor:
        """The stack's int8 trits (E, d_in, d_out), decoded when packed."""
        return ops.twd_decode_stack(self.packed, self.d_in) if self.is_packed else self.trits


class MoE(nn.Module):
    """Serving weights of one MoE FFN, named as the JAX package's tree: the
    ``router`` (d_model, E) in the model's dtype, the three expert stacks and,
    with shared experts, ``shared_gate``/``shared_in``/``shared_out``.

    After each call ``load`` holds the routed copies each expert received
    (E,) and ``capacity`` the call's per-expert capacity; ``dropped`` is the
    copies over it (a 0-d tensor on the model's device, read without a
    sync).  ``experts`` (e0, e1) holds the stacks of those experts only
    (expert parallelism; ``mesh`` is then the rank's ``plan.Mesh``, over
    whose "model" axis the partial combines are summed)."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device=None,
                 experts: tuple[int, int] | None = None):
        super().__init__()
        e, d, tc = cfg.moe, cfg.d_model, cfg.ternary
        self.experts = experts if experts is not None else (0, e.n_experts)
        self.mesh = None
        n = self.experts[1] - self.experts[0]
        self.register_buffer("router", torch.zeros((d, e.n_experts), dtype=dtype,
                                                   device=device))
        self.experts_gate = ExpertStack(n, d, e.d_expert, tc, device)
        self.experts_in = ExpertStack(n, d, e.d_expert, tc, device)
        self.experts_out = ExpertStack(n, e.d_expert, d, tc, device)
        if e.n_shared:
            fs = e.d_expert * e.n_shared
            self.shared_gate = TernaryLinear(d, fs, tc, device)
            self.shared_in = TernaryLinear(d, fs, tc, device)
            self.shared_out = TernaryLinear(fs, d, tc, device)
        self.load: torch.Tensor | None = None
        self.capacity = 0

    @property
    def dropped(self) -> torch.Tensor:
        return (self.load - self.capacity).clamp(min=0).sum()


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> dict:
    """Master weights ~ N(0, s^2) from ``gen``: the router and gate/up stacks
    at s = d_model^-1/2, the down stack at (2 d_expert n_layers)^-1/2, the
    shared expert's linears as the dense FFN's."""
    e, d, f = cfg.moe, cfg.d_model, cfg.moe.d_expert

    def w(shape, scale):
        return (torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
                * scale).to(dtype)

    p = {"router": w((d, e.n_experts), d ** -0.5),
         "experts_gate": {"w": w((e.n_experts, d, f), d ** -0.5)},
         "experts_in": {"w": w((e.n_experts, d, f), d ** -0.5)},
         "experts_out": {"w": w((e.n_experts, f, d), (f * 2 * cfg.n_layers) ** -0.5)}}
    if e.n_shared:
        fs = f * e.n_shared
        p["shared_gate"] = tlin_init(gen, d, fs, dtype)
        p["shared_in"] = tlin_init(gen, d, fs, dtype)
        p["shared_out"] = tlin_init(gen, fs, d, dtype, scale=(fs * 2 * cfg.n_layers) ** -0.5)
    return p


def pack_stack(trits: torch.Tensor) -> torch.Tensor:
    """int8 trits (E, K, N) -> base-3 packed (E, R, N), each expert packed
    along K with R a multiple of ROW_ALIGN."""
    return twd.pack_ternary(trits.movedim(0, 1), row_align=ROW_ALIGN).movedim(1, 0).contiguous()


def export_moe(p: dict, cfg: ModelConfig) -> dict:
    """Master weights -> serving leaves: per-expert absmean scale (the mean
    over each expert's (K, N) in w's dtype, + 1e-6), trits packed per expert
    or kept as int8; the router as it is; the shared linears as
    ``export_tlin``."""
    check_format(cfg.ternary)
    out = {"router": p["router"]}
    for name in EXPERT_STACKS:
        w = p[name]["w"]
        gamma = w.abs().mean(dim=(1, 2), keepdim=True, dtype=torch.float32).to(w.dtype)
        gamma = gamma + tq.EPS
        trits = torch.clamp(torch.round(w / gamma), -1.0, 1.0).to(torch.int8)
        key = "packed" if cfg.ternary.serve_format == "packed" else "trits"
        out[name] = {key: pack_stack(trits) if key == "packed" else trits,
                     "scale": gamma.float()}
    for name in SHARED:
        if name in p:
            out[name] = export_tlin(p[name], cfg.ternary)
    return out


def expert_weights(p: MoE, x_dtype: torch.dtype) -> list[torch.Tensor]:
    """(wg, wi, wo): every expert's weights in x's dtype, the trits times the
    scale cast to x's dtype.  The JAX package casts the trits to x's dtype
    first; a trit in {-1, 0, 1} casts exactly, so one multiply that
    promotes the int8 trits gives the same bits in one pass."""
    out = []
    for name in EXPERT_STACKS:
        st = getattr(p, name)
        out.append(torch.mul(st.trits_of(), st.scale.to(x_dtype)))
    return out


class Route(NamedTuple):
    """One call's routing of T tokens to k experts each (the copies in
    routing order: copy c is token c // k's j = c % k-th choice)."""
    gate: torch.Tensor     # (T*k,) the renormalised gates, 0 for a dropped copy
    slot: torch.Tensor     # (T*k,) each copy's buffer row, E*C for a dropped copy
    source: torch.Tensor   # (E*C,) each buffer row's token, T for an empty row
    copy: torch.Tensor     # (E*C,) each buffer row's copy, T*k for an empty row
    counts: torch.Tensor   # (E,) the routed copies of each expert, drops included


def top_k_experts(probs: torch.Tensor, k: int) -> torch.Tensor:
    """Each token's k experts (T, k) in routing order: the k largest router
    probabilities, largest first (a routing decision: a run that replays
    another's decisions at near ties patches this function).  torch.topk
    and lax.top_k order exact ties differently; the router's float32
    probabilities of distinct experts do not tie with these weights."""
    return torch.topk(probs, k, dim=-1).indices


def route(x_tok: torch.Tensor, router: torch.Tensor, cfg: ModelConfig, capacity: int,
          experts: tuple[int, int] | None = None) -> Route:
    """Route the (T, D) normed rows: float32 logits (TF32 off), softmax,
    top-k, the gates renormalised over the k chosen; a stable argsort of
    the copies' experts ranks each copy in its expert, and a copy whose
    rank is not below ``capacity`` is dropped.  With ``experts`` (e0, e1)
    the buffer holds those experts' rows only, and a copy routed to another
    expert goes to the dump row as a drop does.  The gates carry the
    router's gradient; the maps are integers."""
    e = cfg.moe
    t = x_tok.shape[0]
    n_e, k, dev = e.n_experts, e.top_k, x_tok.device
    e0, e1 = experts if experts is not None else (0, n_e)
    with full_f32():
        logits = x_tok.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)                        # (T, E)
    expert = top_k_experts(probs, k)                             # (T, K)
    gate = torch.gather(probs, -1, expert)
    gate = gate / gate.sum(dim=-1, keepdim=True)

    flat_e = expert.reshape(-1)                                  # (T*K,)
    order = torch.argsort(flat_e, stable=True)
    counts = torch.zeros(n_e, dtype=flat_e.dtype, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, dim=0) - counts
    copies = torch.arange(t * k, device=dev)
    pos_sorted = copies - starts[flat_e[order]]
    pos = torch.empty_like(flat_e).scatter_(0, order, pos_sorted)  # rank in expert
    ok = (pos < capacity) & (flat_e >= e0) & (flat_e < e1)
    dump = (e1 - e0) * capacity
    slot = torch.where(ok, (flat_e - e0) * capacity + pos, dump)
    # the inverse map; every dropped copy writes the dump row, cut off after
    copy = torch.full((dump + 1,), t * k, dtype=slot.dtype, device=dev).scatter_(
        0, slot, copies)[:dump]
    source = torch.where(copy < t * k, copy // k, t)
    return Route(torch.where(ok, gate.reshape(-1), 0.0), slot, source, copy, counts)


def _pad_row(x: torch.Tensor) -> torch.Tensor:
    """x (N, D) with a zero row appended: what an index of N reads."""
    return torch.cat([x, x.new_zeros((1, x.shape[1]))])


class _Dispatch(torch.autograd.Function):
    """buf[r] = x[source[r]] (a zero row where r is empty): the experts'
    buffer from the (T, D) inputs.  Backward, with no atomics: each copy
    reads its row's gradient (a dropped copy zero), and a token sums its k
    copies in routing order."""

    @staticmethod
    def forward(ctx, x, source, slot, k):
        ctx.save_for_backward(slot)
        ctx.k = k
        return _pad_row(x)[source]

    @staticmethod
    def backward(ctx, g):
        (slot,) = ctx.saved_tensors
        per_copy = _pad_row(g)[slot].view(-1, ctx.k, g.shape[1])
        out = per_copy[:, 0]
        for c in per_copy.unbind(1)[1:]:
            out = out + c
        return out, None, None, None


class _Combine(torch.autograd.Function):
    """y_copy[c] = y[slot[c]] (a zero row for a dropped copy): each copy's
    expert output.  Backward: each buffer row reads the gradient of the one
    copy it holds (zero where it is empty), a gather with no atomics."""

    @staticmethod
    def forward(ctx, y, slot, copy):
        ctx.save_for_backward(copy)
        return _pad_row(y)[slot]

    @staticmethod
    def backward(ctx, g):
        (copy,) = ctx.saved_tensors
        return _pad_row(g)[copy], None, None


def dispatch_compute(x_tok: torch.Tensor, x_in: torch.Tensor, weights, router: torch.Tensor,
                     cfg: ModelConfig, capacity: int, experts: tuple[int, int] | None = None):
    """Route the (T, D) normed rows ``x_tok``, run every expert (of
    ``experts`` (e0, e1) only, whose stacks ``weights`` holds; default all)
    on its kept copies of the expert inputs ``x_in`` (T, D), and combine ->
    ((T, D) in x_in's dtype, the routed copies of each expert (E,), drops
    included).
    The same code serves and trains: under autograd the dispatch and the
    combine are gathers through the slot <-> copy maps whose backward is the
    inverse gather, so no gradient is summed with atomics."""
    e = cfg.moe
    t, d = x_tok.shape
    k = e.top_k
    n_e = weights[0].shape[0]   # the experts whose stacks are here
    wg, wi, wo = weights
    with torch.profiler.record_function("moe_dispatch"):
        r = route(x_tok, router, cfg, capacity, experts)
        buf = _Dispatch.apply(x_in, r.source, r.slot, k).view(n_e, capacity, d)
        h = silu(torch.bmm(buf, wg)) * torch.bmm(buf, wi)
        y = torch.bmm(h, wo).view(n_e * capacity, d)
        contrib = _Combine.apply(y, r.slot, r.copy) * r.gate.to(y.dtype)[:, None]
        out = torch.zeros((t, d), dtype=y.dtype, device=y.device)
        for c in contrib.view(t, k, d).unbind(1):   # a token's copies in routing order
            out = out + c
    return out, r.counts


def shared_ffn(p: MoE, x: torch.Tensor, ca: ops.DasTopK | None) -> torch.Tensor:
    """The always-on experts on the normed rows x; gate and up share the
    DAS step ``ca`` of x (None with DAS off)."""
    g = p.shared_gate(x, ca)
    u = p.shared_in(x, ca)
    return p.shared_out(silu(g) * u)


def decode_capacity(cfg: ModelConfig, batch: int) -> int:
    """No-drop per-expert capacity for a decode tick of ``batch`` tokens: an
    expert receives at most one routed copy of each token, so capacity ==
    batch makes drops impossible, and a request's tokens do not depend on
    its batch-mates."""
    del cfg
    return max(1, batch)


def prefill_capacity(cfg: ModelConfig, t: int) -> int:
    """The capacity-factor bound for t tokens: max(1, min(t, int(t * top_k /
    E * cf) + 1))."""
    e = cfg.moe
    return max(1, min(t, int(t * e.top_k / e.n_experts * e.capacity_factor) + 1))


def moe_apply(p: MoE, cfg: ModelConfig, x: torch.Tensor, norm_scale: torch.Tensor, *,
              capacity: int | None = None) -> torch.Tensor:
    """The MoE FFN of the residual x (B, S, D) normed by ``norm_scale`` ->
    (B, S, D) in x's dtype.  ``capacity`` is the per-expert token capacity
    (the engine's decode passes ``decode_capacity``); None takes the
    capacity-factor bound over all B*S tokens."""
    b, s, d = x.shape
    t = b * s
    cap = capacity if capacity is not None else prefill_capacity(cfg, t)
    das = cfg.ternary.das
    if das is None:
        normed = rmsnorm(norm_scale, x).reshape(t, d)
        x_in, ca = normed, None
    else:
        ca = ops.das_topk(x, keep=das.keep, block=das.block, norm_scale=norm_scale,
                          with_mask=False, with_normed=True, with_dense=True)
        normed, x_in = ca.normed, ca.dense
    p.capacity = cap
    y, p.load = dispatch_compute(normed, tq.int8_fake_quant(x_in),
                                 expert_weights(p, x.dtype), p.router, cfg, cap, p.experts)
    if p.mesh is not None:   # the partial combines of every rank's experts
        y = collectives.psum(y.float(), p.mesh, "model").to(y.dtype)
    if cfg.moe.n_shared:
        y = y + shared_ffn(p, normed, ca)
    return y.reshape(b, s, d)


def moe_train(p: dict, cfg: ModelConfig, x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The MoE FFN over whole sequences on master weights ``p`` (the JAX
    package's tree), x (B, S, D) the normed rows -> (B, S, D) in x's dtype:
    the JAX package's no-mesh branch under autograd, at the training
    capacity ``prefill_capacity(cfg, B*S)``.  Every expert stack is the
    STE fake-quant with one scale an expert, in x's dtype; the experts'
    input (and the shared expert's gate and up) is x DAS-masked and int8
    fake-quantized (``tlin_train_input``); the router's gradient flows
    through the gates.

    With ``mesh`` (a rank of a Topology whose "model" axis cuts the
    experts: ``p`` holds the stacks of its experts [e0, e1), the shared
    expert's column / row shards), x is the rank's rows, replicated over
    "model": the rank routes them over all experts, runs its own (the
    copies routed elsewhere go to the dump row, as drops do) at the
    capacity of its rows, the JAX package's ``t_local``, and returns its
    float32 partial (its experts' combine plus the shared expert's
    row-parallel partial) for the block to sum over "model".  The router is
    replicated, but a rank's gates carry only its experts' share of its
    gradient: ``copy_to_model`` sums the ranks' shares in the backward."""
    b, s, d = x.shape
    t, tc = b * s, cfg.ternary
    xt = x.reshape(t, d)
    xq = tlin_train_input(xt, tc)
    weights = [(tq.ternary_fake_quant_stacked(p[n]["w"]) if tc.enabled else p[n]["w"])
               .to(x.dtype) for n in EXPERT_STACKS]
    n = weights[0].shape[0]
    mine = () if mesh is None else ((mesh.model_index * n, (mesh.model_index + 1) * n),)
    y, _ = dispatch_compute(xt, xq, weights, collectives.copy_to_model(p["router"], mesh), cfg,
                            prefill_capacity(cfg, t), *mine)
    if mesh is not None:
        y = y.float()
    if cfg.moe.n_shared:
        h = silu(tlin_train(p["shared_gate"], xq, tc)) * tlin_train(p["shared_in"], xq, tc)
        y = y + tlin_train(p["shared_out"], tlin_train_input(h, tc, mesh), tc,
                           partial=mesh is not None)
    return y.reshape(b, s, d)
