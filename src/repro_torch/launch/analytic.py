"""Workload-intrinsic roofline terms per (arch x shape x mesh) cell.

A copy of the JAX package's ``launch/analytic.py`` over the port's own
``ModelConfig`` (configs/base.py, field for field the JAX package's).  The
terms are the same arithmetic on paper whatever runs the model; ``terms``
prices them at an H100's rates.

Why this exists: a counted step (the dry run, ``launch.dryrun``) counts
op-level bytes, every op's inputs and outputs, which overcounts the HBM
traffic a fused kernel makes; this module derives the three roofline terms
from first principles, the same arithmetic a roofline analysis would do on
paper, and the report shows both sources.

Counting conventions (documented in EXPERIMENTS.md §Roofline):
  * train flops factor = 8 x params x tokens with remat (2 fwd + 4 bwd +
    2 recompute), 6 without; serving = 2.
  * DAS does NOT discount flops: the counted path is masked-dense (the
    S_a FLOP cut needs the hand-written DAS kernels; reported as
    headroom).
  * attention keys/query: full = (L+1)/2 averaged, LPSA = TL_SA, local =
    window (exact row-average for short sequences).
  * activation HBM traffic: layer in/out + mixer internals, ~6 touches per
    token-layer forward (r/w of x, qkv/o or ssm streams), x2.5 for train
    (bwd reads saved + writes grads, remat recompute reads).
  * collectives: Megatron-TP 2 all-reduces per block (fwd; x2 more for bwd),
    EP psum per MoE block, ZeRO-1 reduce-scatter + all-gather of params,
    wire factor 2x for ring all-reduce.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core.perfmodel import H100_SXM

__all__ = ["cell_analytic", "AnalyticCost", "LINK_BW"]

BYTES = {"bfloat16": 2, "float32": 4}


# a GPU's share of the link between nodes: InfiniBand NDR, 400 Gb/s a GPU
# (a 16-way "model" axis spans two 8-GPU H100 nodes, so its collectives
# cross it)
LINK_BW = 50e9


@dataclass(frozen=True)
class AnalyticCost:
    flops_per_dev: float
    hbm_bytes_per_dev: float
    coll_bytes_per_dev: float

    def terms(self, peak=H100_SXM.peak_tops_high * 1e12, hbm=H100_SXM.hbm_gbps * 1e9,
              link=LINK_BW):
        """(compute, memory, collective) seconds at the given rates; the
        defaults an H100 SXM5's dense bf16 rate and HBM3 rate
        (``core.perfmodel.H100_SXM``) and ``LINK_BW``."""
        return (self.flops_per_dev / peak, self.hbm_bytes_per_dev / hbm,
                self.coll_bytes_per_dev / link)


def _avg_keys(kind: str, cfg: ModelConfig, L: int, serve_sparse: bool,
              decode_ctx: int | None = None) -> float:
    """Average attended keys per query for a mixer kind."""
    if kind == "local":
        w = cfg.window
        return min(w, decode_ctx if decode_ctx else (w + 1) / 2 if L < w else w)
    if cfg.lpsa is not None and serve_sparse:
        tl = cfg.lpsa.tl_sa
        base = decode_ctx if decode_ctx else L
        return min(tl, base)
    return decode_ctx if decode_ctx else (L + 1) / 2


def _weight_bytes_per_param(cfg: ModelConfig, serving: bool) -> float:
    if not serving:
        return BYTES[cfg.dtype]
    if not cfg.ternary.enabled:
        return 2.0
    return {"packed": 0.2, "int8": 1.0, "bf16": 2.0}[cfg.ternary.serve_format]


def cell_analytic(cfg: ModelConfig, shape: ShapeSpec, n_dev: int,
                  model_shards: int = 16, *, serve_sparse: bool = True,
                  zero1: bool = True) -> AnalyticCost:
    B, L = shape.global_batch, shape.seq_len
    train = shape.kind == "train"
    decode = shape.kind == "decode"
    serving = not train
    act_b = BYTES[cfg.dtype]
    d = cfg.d_model
    kinds = cfg.layer_kinds()

    tokens = B * (1 if decode else L)
    f = (8.0 if cfg.remat else 6.0) if train else 2.0

    # ---- parameter counts ---------------------------------------------------
    n_linear_active = 0
    n_linear_total = 0
    for kind in kinds:
        if kind in ("attn", "local"):
            blk = d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d
        elif kind == "mamba":
            s = cfg.ssm
            di = s.expand * d
            blk = 2 * d * di + di * d + 2 * d * s.state_dim
        elif kind in ("rwkv", "gla"):
            blk = 5 * d * d + (2 * d * cfg.d_ff if kind == "rwkv" else 0)
        else:
            blk = 0
        n_linear_active += blk
        n_linear_total += blk
        if cfg.moe is not None and kind in ("attn", "local", "gla"):
            e = cfg.moe
            per_e = 3 * d * e.d_expert
            n_linear_active += (e.top_k + e.n_shared) * per_e + d * e.n_experts
            n_linear_total += (e.n_experts + e.n_shared) * per_e + d * e.n_experts
        elif kind in ("attn", "local", "gla") and cfg.moe is None:
            nf = (3 if cfg.ffn_kind == "gated" else 2) * d * cfg.d_ff
            n_linear_active += nf
            n_linear_total += nf
    n_embed = cfg.vocab_padded * d

    # ---- FLOPs ---------------------------------------------------------------
    flops = f * n_linear_active * tokens           # 2 MAC ops folded into f
    flops += f * n_embed * tokens                  # logits head (tied)
    for kind in kinds:
        if kind in ("attn", "local"):
            kq = _avg_keys(kind, cfg, L, serve_sparse,
                           decode_ctx=L if decode else None)
            flops += f * 2 * cfg.n_heads * cfg.head_dim_ * kq * tokens
        elif kind == "mamba":
            s = cfg.ssm
            di = s.expand * d
            nh = di // s.head_dim
            c = min(s.chunk, L if not decode else 1)
            flops += f * tokens * (c * nh * s.head_dim + 2 * di * s.state_dim)
        elif kind in ("rwkv", "gla"):
            hd = cfg.head_dim_
            c = 1 if decode else min(56, L)
            flops += f * tokens * cfg.n_heads * hd * (c + 2 * hd)
    flops_per_dev = flops / n_dev

    # ---- HBM bytes per device -------------------------------------------------
    wb = _weight_bytes_per_param(cfg, serving)
    weight_bytes = (n_linear_total * wb + n_embed * act_b) / model_shards
    # weights stream once per step from each device's HBM shard
    if train:
        # + grads f32 + 2 adam moments touched (ZeRO: sharded over data too)
        opt_touch = (n_linear_total + n_embed) * 4 * 3 / n_dev
    else:
        opt_touch = 0.0
    t_loc = tokens / max(1, n_dev // model_shards)  # tokens per model-replica
    act_touch = 6.0 * (2.5 if train else 1.0)
    act_bytes = t_loc * d * act_b * len(kinds) * act_touch
    kv_bytes = 0.0
    if decode:
        for kind in kinds:
            if kind in ("attn", "local"):
                kq = _avg_keys(kind, cfg, L, serve_sparse, decode_ctx=L)
                kv_bytes += (B / max(1, n_dev // model_shards)) * kq \
                    * cfg.kv_dim * 2 * 2 / 1  # read K+V bf16 over kept keys
            elif kind == "mamba":
                s = cfg.ssm
                di = s.expand * d
                kv_bytes += B * (di // s.head_dim) * s.head_dim * s.state_dim * 4 * 2
            elif kind in ("rwkv", "gla"):
                kv_bytes += B * cfg.n_heads * cfg.head_dim_ ** 2 * 4 * 2
    hbm = weight_bytes + opt_touch + act_bytes + kv_bytes

    # ---- collective bytes per device -------------------------------------------
    coll = 0.0
    ar_wire = 2.0
    n_tp_blocks = sum(1 for k in kinds)
    # activation all-reduces: 2 per block fwd (+2 bwd when training)
    coll += t_loc * d * act_b * n_tp_blocks * 2 * ar_wire * (2 if train else 1)
    if cfg.moe is not None:
        coll += t_loc * d * act_b * sum(
            1 for k in kinds if k in ("attn", "local")) * ar_wire  # EP psum
    if train:
        params_bytes = (n_linear_total + n_embed) * 4
        if zero1:
            coll += 2.0 * params_bytes / n_dev * 2  # RS grads + AG params
        else:
            coll += ar_wire * params_bytes / n_dev
    return AnalyticCost(flops_per_dev, hbm, coll)
