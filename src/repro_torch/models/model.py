"""Public model API: TernaryLM, init / export, prefill, decode step, caches.

``init_params`` draws master weights from a seeded ``torch.Generator`` into
the JAX package's tree layout ({embed, final_norm, layers: {stacked, tail,
shared}} with {"w"} leaves, a block's mixer as ``attn``, ``mamba``,
``rwkv`` or ``gla`` (their dense LoRAs, projections, mixes and norms plain
leaves), zamba2's one attention under ``layers.shared``, its FFN as
``ffn`` or, for a MoE config, ``moe`` with its router and expert stacks,
and a dense ``head`` when the embeddings are untied); ``export_serving``
quantizes them to the config's serve format (base-3 packed, or int8 trits)
and loads the result into a ``TernaryLM``.  ``init_serving`` gives the same model layer by layer, never
holding more than one layer's master weights (qwen3-moe-30b-a3b's take
~58 GB in bfloat16).  ``TernaryLM.from_tree`` loads any serving tree in
that layout — the port's own export, or the JAX package's through
``repro_torch.bridge`` — leaf path by leaf path.  ``trits_from_packed``
turns a packed model into the int8-resident form on its device, through the
``twd_decode`` kernel.

Tensor and expert parallelism: ``shard_model`` cuts a full model (the
host copy of the serving weights) into one rank's local model under a
``distributed.plan.Topology``: q / k / v heads and the FFN's gate / up
columns (column-parallel, no collective), wo's and the FFN down's rows
(row-parallel: the float32 partial summed over "model" before the cast),
the vocab rows of the embedding and the untied head's columns, the experts
of every MoE block.  The local model's embedding lookup takes its own rows
and zeros elsewhere, then the sum over "model"; its logits are gathered to
(B, V) float32 on every rank of "model" before the sampler.  Its config is
the full one with the local head counts and d_ff, so the attention, its
caches and the FFN run unchanged on their shards.

The stub-frontend models (musicgen-medium, pixtral-12b; ``uses_embeds``)
take float embeddings in place of token ids: ``prefill`` passes them
through in their own dtype, as the JAX package's ``_inputs_to_x`` does, so
a float32 prompt runs a float32 residual stream under a bfloat16 config
(ternary weights, bfloat16 norm scales, embeddings and head, bfloat16 slot
caches).  Their decode steps take token ids with an optional ``forced``
mask and its float32 rows, as the JAX engine's step builds its input.

Training: ``forward`` and ``loss_fn`` run a master tree (``init_params``,
or the JAX package's through ``bridge.load_master_tree``) under autograd,
from token ids or float embeddings, through ``transformer.stack_train``
(every block kind: attention, MoE, rwkv, gla, mamba).  Under a Topology
(``Runtime.mesh``) they run a rank's shard of the tree (``shard_params``;
``gather_params`` is its inverse) on the rank's batch rows: the
vocab-parallel embedding lookup, the blocks on the rank's heads and d_ff
(``local_config``) or its experts (``moe.moe_train`` with the mesh), the
tied logits of the rank's vocab columns (padding
masked by their global ids), and a vocab-parallel cross entropy (the row
max and the sum of exponentials over "model", the gold logit from the
rank that holds it).  The loss is divided by the global token count (over
the data axes), so the ranks' losses and gradients sum to the JAX
package's ``loss_fn`` over the whole batch.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives
from repro_torch.distributed.plan import ShardingPlan, shard_bounds
from repro_torch.distributed.sharding import leaf_spec
from repro_torch.kernels import ops
from repro_torch.models import attention as A
from repro_torch.models import gla as G
from repro_torch.models import kvcache as KV
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv6 as R
from repro_torch.models import transformer as T
from repro_torch.models.ternary_linear import (TRITS_FORMATS, TernaryLinear,
                                               export_tlin, shard_scales, shard_tlin,
                                               tlin_init)
from repro_torch.tree import leaves, leaves_with_paths, tree_map, unflatten

__all__ = ["TernaryLM", "RankShard", "Runtime", "embed_scale", "uses_embeds", "init_params",
           "export_serving", "init_serving", "trits_from_packed", "flatten_tree",
           "kv_replicas", "check_shardable", "model_bounds", "local_config", "shard_model",
           "shard_params", "gather_params", "prefill", "decode_step", "init_caches",
           "forward", "loss_fn"]

Runtime = T.Runtime


@dataclass(frozen=True)
class RankShard:
    """What one rank of a Topology holds of a model: its ``plan.Mesh``, the
    vocab rows [lo, hi) of the embedding (the untied head's columns), and
    the experts [e0, e1) of every MoE block (None without MoE)."""
    mesh: object
    vocab: tuple
    experts: tuple | None = None


class TernaryLM(nn.Module):
    """Serving weights of a ternary LM, dense, MoE, hybrid or attention-free,
    on the CUDA device unless ``device="cpu"``: the embedding, the untied
    dense ``head`` (d_model, vocab_padded) where the config has one, the
    blocks (each with its mixer and its FFN or MoE), the one ``shared``
    attention of a ``shared_attn`` config, and the final norm.  With a
    ``shard`` (a ``RankShard``, ``shard_model``'s) it holds that rank's
    vocab rows and experts only."""

    def __init__(self, cfg: ModelConfig, device=None, shard: RankShard | None = None):
        super().__init__()
        dt = L.torch_dtype(cfg.dtype)
        device = resolve_device(device)
        self.cfg = cfg
        self.shard = shard
        self.embed_scale = embed_scale(cfg)
        rows = cfg.vocab_padded if shard is None else shard.vocab[1] - shard.vocab[0]
        self.register_buffer("embed", torch.zeros((rows, cfg.d_model), dtype=dt,
                                                  device=device))
        if not cfg.tie_embeddings:
            self.register_buffer("head", torch.zeros((cfg.d_model, rows), dtype=dt,
                                                     device=device))
        self.final_norm = L.RMSNorm(cfg.d_model, dt, device)
        experts = None if shard is None else shard.experts
        self.layers = nn.ModuleList(T.Block(cfg, kind, dt, device, experts)
                                    for kind in cfg.layer_kinds())
        # one set of buffers, which every attention block runs
        self.shared = A.Attention(cfg, device) if _has_shared(cfg) else None
        # logits past `vocab` are padding rows: masked out
        bias = torch.where(torch.arange(cfg.vocab_padded) < cfg.vocab, 0.0, -1e30)
        self.register_buffer("vocab_bias", bias.to(device), persistent=False)
        self._head_cast: tuple | None = None   # (dtype, storage, version, copy)

    def head_as(self, dtype: torch.dtype) -> torch.Tensor:
        """The untied head in ``dtype``: the buffer itself in its own dtype,
        else a copy made once and kept while the head is unchanged (a float32
        stream's logits would otherwise copy pixtral-12b's 1.34 GB bfloat16
        head into 2.68 GB of float32 on every step; the copy is exact).  The
        copy is made anew when the head moves or is written in place."""
        head = self.head
        if dtype == head.dtype:
            return head
        key = (dtype, head.data_ptr(), head._version)
        if self._head_cast is None or self._head_cast[:3] != key:
            self._head_cast = None          # free the stale copy first
            self._head_cast = (*key, head.to(dtype))
        return self._head_cast[3]

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @classmethod
    def from_tree(cls, tree: dict, cfg: ModelConfig, device=None) -> "TernaryLM":
        """A model on ``device`` holding the serving tree's tensors.

        Every buffer must have a leaf of its shape and dtype at its path, and
        every leaf a buffer; anything else raises."""
        model = cls(cfg, device)
        _load(model.state_dict(), flatten_tree(tree, cfg), cfg)
        return model


def embed_scale(cfg: ModelConfig) -> bool:
    """Whether token embeddings are scaled by sqrt(d): the JAX package
    scales a dense gemma model's."""
    return cfg.family == "dense" and cfg.name.startswith("gemma")


def uses_embeds(cfg: ModelConfig) -> bool:
    """Whether the config's prompts are float embeddings (a stub frontend)."""
    return cfg.frontend != "none"


def _has_shared(cfg: ModelConfig) -> bool:
    return cfg.shared_attn and any(k in T.ATTN_KINDS for k in cfg.layer_kinds())


def _load(own: dict, flat: dict, cfg: ModelConfig) -> None:
    """Copy each leaf of ``flat`` into the buffer of its name in ``own``;
    the names must be the same, and each leaf's shape and dtype its buffer's."""
    missing, extra = sorted(set(own) - set(flat)), sorted(set(flat) - set(own))
    if missing or extra:
        raise KeyError(f"serving tree does not match {cfg.name}: missing "
                       f"{missing[:8]}, unexpected {extra[:8]}")
    for name, buf in own.items():
        src = flat[name]
        if tuple(src.shape) != tuple(buf.shape) or src.dtype != buf.dtype:
            raise ValueError(f"{name}: tree has {tuple(src.shape)} {src.dtype}, "
                             f"model wants {tuple(buf.shape)} {buf.dtype}")
        buf.copy_(src)


def flatten_tree(tree: dict, cfg: ModelConfig) -> dict:
    """{module-style name: leaf} of a serving tree in the JAX package's
    layout; scan-stacked groups (leading group axis) are split per layer,
    and the shared attention goes to the model's ``shared``."""
    lay = tree["layers"]
    blocks: list = []
    if lay.get("stacked") is not None:
        per_pos = lay["stacked"]
        groups = leaves(per_pos[0])[0].shape[0]
        for g in range(groups):
            for pos_tree in per_pos:
                blocks.append(tree_map(lambda a, g=g: a[g], pos_tree))
    blocks.extend(lay["tail"])
    if len(blocks) != cfg.n_layers:
        raise ValueError(f"tree holds {len(blocks)} layers, {cfg.name} has "
                         f"{cfg.n_layers}")
    out: dict = {}
    top = {"embed": tree["embed"], "final_norm": tree["final_norm"]}
    if "head" in tree:
        top["head"] = tree["head"]
    _flatten(top, "", out)
    _flatten(lay.get("shared"), "shared.", out)
    for i, b in enumerate(blocks):
        _flatten(b, f"layers.{i}.", out)
    return out


def _flatten(tree, prefix: str, out: dict) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}.", out)
    elif tree is not None:
        out[prefix[:-1]] = tree


class _MetaGenerator(torch.Generator):
    """A generator whose draws land on the ``meta`` device: every leaf at
    its shape and dtype, no value drawn and nothing allocated (the dry
    run's full-size trees, kimi-k2-1t-a32b's ~1 T parameters included)."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def _generator(seed: int, device) -> torch.Generator:
    dev = resolve_device(device)
    gen = _MetaGenerator() if dev.type == "meta" else torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


def _attn_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dt, d, qd, kvd = L.torch_dtype(cfg.dtype), cfg.d_model, cfg.q_dim, cfg.kv_dim
    return {"wq": tlin_init(gen, d, qd, dt),
            "wk": tlin_init(gen, d, kvd, dt),
            "wv": tlin_init(gen, d, kvd, dt),
            "wo": tlin_init(gen, qd, d, dt, scale=(qd * 2 * cfg.n_layers) ** -0.5)}


def _block_params(gen: torch.Generator, cfg: ModelConfig, kind: str) -> dict:
    """One block's master weights, drawn from ``gen`` in a fixed order: the
    norms, the mixer (attention unless the config shares one, mamba, rwkv
    or gla), then the FFN or the MoE (a mamba or rwkv block has none)."""
    dt, dev = L.torch_dtype(cfg.dtype), gen.device
    d, f = cfg.d_model, cfg.d_ff
    p = {"norm1": {"scale": torch.zeros(d, dtype=dt, device=dev)}}
    if kind == "mamba":
        p["mamba"] = M.mamba_init(gen, cfg, dt)
        return p
    if kind == "rwkv":
        p["rwkv"] = R.rwkv_init(gen, cfg, dt)
    elif kind == "gla":
        p["gla"] = G.gla_init(gen, cfg, dt)
    elif not cfg.shared_attn:
        p["attn"] = _attn_params(gen, cfg)
    p["norm2"] = {"scale": torch.zeros(d, dtype=dt, device=dev)}
    if kind == "rwkv":
        return p
    if cfg.moe is not None:
        p["moe"] = MOE.moe_init(gen, cfg, dt)
        return p
    ffn = {} if cfg.ffn_kind == "mlp" else {"w_gate": tlin_init(gen, d, f, dt)}
    ffn["w_in"] = tlin_init(gen, d, f, dt)
    ffn["w_out"] = tlin_init(gen, f, d, dt, scale=(f * 2 * cfg.n_layers) ** -0.5)
    p["ffn"] = ffn
    return p


def _embed_param(gen: torch.Generator, cfg: ModelConfig) -> torch.Tensor:
    """The embedding, drawn from ``gen`` before the blocks."""
    embed = torch.randn((cfg.vocab_padded, cfg.d_model), generator=gen, device=gen.device)
    return (embed * 0.02).to(L.torch_dtype(cfg.dtype))


def _top_params(gen: torch.Generator, cfg: ModelConfig, embed: torch.Tensor) -> dict:
    """``embed``, the final norm and the untied head, drawn from ``gen``
    after the blocks."""
    dt, dev, d = L.torch_dtype(cfg.dtype), gen.device, cfg.d_model
    top = {"embed": embed, "final_norm": {"scale": torch.zeros(d, dtype=dt, device=dev)}}
    if not cfg.tie_embeddings:
        head = torch.randn((d, cfg.vocab_padded), generator=gen, device=dev) * 0.02
        top["head"] = head.to(dt)
    return top


def init_params(cfg: ModelConfig, *, seed: int = 0, device=None) -> dict:
    """Seeded random master weights in cfg.dtype, one tree per layer, drawn
    in the order embedding, blocks, shared attention, head.  On
    ``device="meta"`` every leaf has its shape and dtype and no value."""
    gen = _generator(seed, device)
    embed = _embed_param(gen, cfg)
    blocks = tuple(_block_params(gen, cfg, kind) for kind in cfg.layer_kinds())
    shared = _attn_params(gen, cfg) if _has_shared(cfg) else None
    return {**_top_params(gen, cfg, embed),
            "layers": {"stacked": None, "tail": blocks, "shared": shared}}


def _export(tree, cfg: ModelConfig):
    """A master tree (or subtree) in the config's serve format."""
    if isinstance(tree, dict):
        if "experts_gate" in tree:
            return MOE.export_moe(tree, cfg)
        if "w" in tree:
            return export_tlin(tree, cfg.ternary)
        return {k: _export(v, cfg) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_export(v, cfg) for v in tree)
    return tree


@torch.no_grad()
def export_serving(params: dict, cfg: ModelConfig) -> TernaryLM:
    """Master weights -> a TernaryLM whose ternary linears and expert stacks
    take the config's serve format (TWD-packed or int8 trits), on the
    master weights' device (a trained tree too: outside autograd)."""
    return TernaryLM.from_tree(_export(params, cfg), cfg, params["embed"].device)


def init_serving(cfg: ModelConfig, *, seed: int = 0, device=None) -> TernaryLM:
    """``export_serving(init_params(cfg, seed=seed, device=device), cfg)``,
    bit for bit, with each layer's master weights drawn, exported into the
    model and dropped before the next layer's are drawn.  On
    ``device="meta"`` the model's leaves have their shapes and dtypes and
    nothing is drawn or exported."""
    gen = _generator(seed, device)
    model = TernaryLM(cfg, gen.device)
    if gen.device.type == "meta":
        return model
    own = model.state_dict()
    embed = _embed_param(gen, cfg)
    for i, kind in enumerate(cfg.layer_kinds()):
        flat: dict = {}
        _flatten(_export(_block_params(gen, cfg, kind), cfg), f"layers.{i}.", flat)
        _load({k: v for k, v in own.items() if k.startswith(f"layers.{i}.")}, flat, cfg)
        del flat
    flat = {}
    if _has_shared(cfg):
        _flatten(_export(_attn_params(gen, cfg), cfg), "shared.", flat)
    _flatten(_top_params(gen, cfg, embed), "", flat)
    _load({k: v for k, v in own.items() if not k.startswith("layers.")}, flat, cfg)
    return model


def trits_from_packed(packed: TernaryLM, cfg: ModelConfig) -> TernaryLM:
    """The int8-resident serving form of a packed model, on its device.

    ``cfg`` has the packed model's shapes and serve format "int8" or "bf16"
    (its DAS and LPSA settings may differ).  Every linear's trits are
    ``ops.twd_decode`` of its packed weights, cut to d_in rows, and every
    expert stack's ``ops.twd_decode_stack`` of its packed stack; the scales,
    router, norms and embeddings are copied."""
    if cfg.ternary.serve_format not in TRITS_FORMATS:
        raise ValueError(f"serve_format {cfg.ternary.serve_format!r} holds no trits")
    out = TernaryLM(cfg, packed.device)
    src = packed.state_dict()
    mods = dict(packed.named_modules())

    def decoded(m: nn.Module) -> torch.Tensor:
        if isinstance(m, TernaryLinear):
            return ops.twd_decode(m.packed, m.d_in)
        return ops.twd_decode_stack(m.packed, m.d_in)

    for name, buf in out.state_dict().items():
        mod, _, leaf = name.rpartition(".")
        val = decoded(mods[mod]) if leaf == "trits" else src[name]
        if val.shape != buf.shape:
            raise ValueError(f"{name}: packed model gives {tuple(val.shape)}, "
                             f"{cfg.name} wants {tuple(buf.shape)}")
        buf.copy_(val)
    return out


# --------------------------------------------------------------------------
# tensor and expert parallelism
# --------------------------------------------------------------------------

# the logical dim each sharded leaf's module cuts (model_bounds' keys)
_ROLE = {"wq": "q", "wo": "q", "wk": "kv", "wv": "kv", "w_gate": "ff", "w_in": "ff",
         "w_out": "ff", "shared_gate": "shared", "shared_in": "shared", "shared_out": "shared",
         "embed": "vocab", "head": "vocab", "experts_gate": "experts",
         "experts_in": "experts", "experts_out": "experts"}


def kv_replicas(cfg: ModelConfig, tp: int) -> int:
    """How many ranks of ``tp`` hold each kv head: 1 where tp divides the kv
    heads; tp / n_kv_heads where the kv heads divide tp (each rank holds the
    one kv head its q heads read, as Megatron's GQA under a wider TP does)."""
    n = cfg.n_kv_heads
    return tp // n if n < tp and tp % n == 0 else 1


def check_shardable(cfg: ModelConfig, tp: int, *, training: bool = False) -> None:
    """Raise ValueError where the port cannot serve (or, with ``training``,
    train) ``cfg`` at ``tp`` ways: an SSM, hybrid or frontend model, or a
    tp that splits a head, the vocab or the experts (both name ROADMAP
    queue 1, item 2, where they wait)."""
    kinds = set(cfg.layer_kinds())
    what = "train" if training else "serve"
    if not kinds <= set(T.ATTN_KINDS) or uses_embeds(cfg) or cfg.shared_attn:
        raise ValueError(
            f"{cfg.name} ({', '.join(sorted(kinds))} blocks"
            f"{', a stub frontend' if uses_embeds(cfg) else ''}) does not {what} under a "
            f"Topology yet: the port shards the attention, FFN and MoE blocks of token "
            f"models; the SSM, hybrid and frontend models wait for ROADMAP queue 1, item 2")
    kv = cfg.n_kv_heads if kv_replicas(cfg, tp) == 1 else tp
    bad = [f"{n}={v}" for n, v, w in (("n_heads", cfg.n_heads, cfg.n_heads),
                                      ("n_kv_heads", cfg.n_kv_heads, kv),
                                      ("vocab_padded", cfg.vocab_padded, cfg.vocab_padded))
           if w % tp]
    if cfg.moe is not None and cfg.moe.n_experts % tp:
        bad.append(f"moe.n_experts={cfg.moe.n_experts}")
    if bad:
        raise ValueError(f"tp={tp} does not divide {cfg.name}'s {', '.join(bad)} (a head "
                         f"split over ranks waits for ROADMAP queue 1, item 2)")
    das = cfg.ternary.das
    if das is not None and (cfg.q_dim // tp) % das.block:
        raise ValueError(
            f"tp={tp}: {cfg.n_heads // tp} heads of {cfg.head_dim_} a rank put a DAS block "
            f"of {das.block} lanes of wo's input across two ranks")


def model_bounds(cfg: ModelConfig, tp: int) -> dict:
    """Each rank's [lo, hi) along every sharded logical dim of ``cfg`` at
    ``tp`` ways (``plan.shard_bounds``): "q" / "kv" (q_dim / kv_dim, whole
    heads; with fewer kv heads than ranks, ``kv_replicas`` ranks in a row
    hold the same kv head), "ff" (d_ff) and "shared" (a shared expert's
    width) on whole DAS blocks with the dense tail on the last rank,
    "vocab" (vocab_padded) and "experts" evenly."""
    das = cfg.ternary.das
    unit = das.block if das is not None else 1
    hd = cfg.head_dim_
    r = kv_replicas(cfg, tp)
    kv = (shard_bounds(cfg.kv_dim, tp, unit=hd) if r == 1 else
          tuple((m // r * hd, (m // r + 1) * hd) for m in range(tp)))
    out = {"q": shard_bounds(cfg.q_dim, tp, unit=hd), "kv": kv,
           "vocab": shard_bounds(cfg.vocab_padded, tp)}
    if cfg.moe is None:
        out["ff"] = shard_bounds(cfg.d_ff, tp, unit=unit)
    else:
        out["experts"] = shard_bounds(cfg.moe.n_experts, tp)
        if cfg.moe.n_shared:
            out["shared"] = shard_bounds(cfg.moe.d_expert * cfg.moe.n_shared, tp, unit=unit)
    return out


def local_config(cfg: ModelConfig, mesh) -> ModelConfig:
    """``cfg`` as one rank of ``mesh`` holds it: its heads (and their head
    size, kept) and its width of d_ff; the attention, its caches and the
    FFN run unchanged on the rank's shard."""
    tp = mesh.topology.tp
    b = model_bounds(cfg, tp)
    d_ff = cfg.d_ff
    if "ff" in b:
        lo, hi = b["ff"][mesh.model_index]
        d_ff = hi - lo
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // tp,
                               n_kv_heads=cfg.n_kv_heads * kv_replicas(cfg, tp) // tp,
                               head_dim=cfg.head_dim_, d_ff=d_ff)


def _role(name: str) -> str:
    """The ``model_bounds`` key of a sharded leaf, by its nearest named
    module."""
    return _ROLE[next(n for n in reversed(name.split(".")) if n in _ROLE)]


@torch.no_grad()
def shard_model(full: TernaryLM, mesh, device=None) -> TernaryLM:
    """One rank's local model, cut from ``full`` (a serving model, e.g. the
    host copy on the CPU) for the rank's place in ``mesh`` (a
    ``plan.Mesh``), on ``device``.  ``ShardingPlan`` says which axis of each
    leaf the "model" axis splits and ``model_bounds`` where; a packed K cut
    is repacked from its trits (``shard_tlin``).  Raises ValueError for a
    config the port does not shard (SSM, hybrid, frontend) or a tp that
    does not divide its heads, vocab or experts."""
    cfg, tp = full.cfg, mesh.topology.tp
    check_shardable(cfg, tp)
    b = {k: v[mesh.model_index] for k, v in model_bounds(cfg, tp).items()}
    model = TernaryLM(local_config(cfg, mesh), device,
                      RankShard(mesh, b["vocab"], b.get("experts")))
    if "shared" in b:   # the shared expert's local width
        fs = b["shared"][1] - b["shared"][0]
        for blk in model.layers:
            d, tc, dev = cfg.d_model, cfg.ternary, model.device
            blk.moe.shared_gate = TernaryLinear(d, fs, tc, dev)
            blk.moe.shared_in = TernaryLinear(d, fs, tc, dev)
            blk.moe.shared_out = TernaryLinear(fs, d, tc, dev)
    specs = ShardingPlan.for_tree(full, mesh.topology, validate=False).params
    src, mods = full.state_dict(), dict(full.named_modules())
    for name, buf in model.state_dict().items():
        spec, val = specs[name], src[name]
        if "model" in spec:
            axis = spec.index("model")
            mod, _, leaf = name.rpartition(".")
            lo, hi = b[_role(name)]
            if isinstance(mods.get(mod), TernaryLinear):   # a K cut repacks on the device
                val = shard_tlin(mods[mod], axis, lo, hi, model.device)[leaf]
            else:
                val = val.narrow(axis, lo, hi - lo)
        if tuple(val.shape) != tuple(buf.shape):
            raise ValueError(f"{name}: the cut gives {tuple(val.shape)}, the local model "
                             f"wants {tuple(buf.shape)}")
        buf.copy_(val)
    key = "packed" if cfg.ternary.serve_format == "packed" else "trits"
    for name, mod in model.named_modules():
        if isinstance(mod, TernaryLinear) and specs[f"{name}.{key}"][:1] == ("model",):
            mod.mesh = mesh   # row-parallel (K sharded): the partial sums over "model"
        elif isinstance(mod, MOE.MoE):
            mod.mesh = mesh
    return model


def _cut_by(cfg: ModelConfig, mesh):
    """The rank's ``model_bounds`` and whether a leaf's role is cut over
    "model": every sharded role, or on a mesh with ``experts_only`` the
    experts alone; raises ValueError where the port does not train ``cfg``
    so."""
    tp, experts_only = mesh.topology.tp, mesh.experts_only
    if not experts_only:
        check_shardable(cfg, tp, training=True)
    elif cfg.moe is None or cfg.moe.n_experts % tp:
        raise ValueError(f"{cfg.name}: the experts alone over tp={tp} need a MoE whose "
                         f"experts tp divides")
    return model_bounds(cfg, tp), (lambda role: not experts_only or role == "experts")


@torch.no_grad()
def shard_params(tree, cfg: ModelConfig, mesh, device=None):
    """One rank's shard of a master tree (``init_params``'s layout; or an
    optimizer moment tree of its shapes) for its place on ``mesh``'s "model"
    axis, on ``device`` (default: each leaf's own): every leaf whose
    ``sharding.leaf_spec`` names "model" cut to the rank's ``model_bounds``
    (heads, DAS blocks of d_ff with the dense tail last, vocab rows), the
    rest copied whole; on a mesh with ``experts_only`` the expert stacks
    alone are cut.
    Raises ValueError for a config the port does not train under a
    Topology."""
    bounds, cut = _cut_by(cfg, mesh)
    b = {k: v[mesh.model_index] for k, v in bounds.items()}
    out = []
    for path, x in leaves_with_paths(tree):
        name = path.replace("/", ".")
        spec = leaf_spec(name, x.ndim)
        x = x.detach()
        if "model" in spec and cut(_role(name)):
            lo, hi = b[_role(name)]
            x = x.narrow(spec.index("model"), lo, hi - lo)
        out.append(x.to(device=x.device if device is None else device, copy=True,
                        memory_format=torch.contiguous_format))
    return unflatten(tree, out)


@torch.no_grad()
def gather_params(tree, cfg: ModelConfig, mesh):
    """The whole tree from each rank's ``shard_params`` shard, on every rank
    of "model" (each cut leaf gathered in float32, exact, and cast back; a
    cut that several ranks hold, a replicated kv head, from its first;
    on a mesh with ``experts_only`` the expert stacks alone).  Every rank of the axis
    calls it, in one order."""
    bounds, cut = _cut_by(cfg, mesh)
    out = []
    for path, x in leaves_with_paths(tree):
        name = path.replace("/", ".")
        spec = leaf_spec(name, x.ndim)
        if "model" in spec and cut(_role(name)):
            cuts = bounds[_role(name)]
            lo, size = cuts[mesh.model_index][0], cuts[-1][1]
            first = cuts.index(cuts[mesh.model_index]) == mesh.model_index
            x = collectives.gather(x.float(), mesh, "model", spec.index("model"), lo,
                                   size, own=first).to(x.dtype)
        out.append(x)
    return unflatten(tree, out)


def _take_embed(model: TernaryLM, tokens: torch.Tensor) -> torch.Tensor:
    """The embedding rows of ``tokens``; a rank's shard looks up its own
    vocab rows, zeros elsewhere, and sums them over "model" (exact)."""
    if model.shard is None:
        return L.take_embed(model.embed, tokens, scale=model.embed_scale)
    lo, hi = model.shard.vocab
    inside = (tokens >= lo) & (tokens < hi)
    rows = F.embedding(torch.where(inside, tokens - lo, 0), model.embed)
    rows = torch.where(inside[..., None], rows, 0).float()
    x = collectives.psum(rows, model.shard.mesh, "model").to(model.embed.dtype)
    return L.scale_embed(x) if model.embed_scale else x


def _logits(model: TernaryLM, x: torch.Tensor) -> torch.Tensor:
    """The final norm, then the tied embedding's or the untied head's
    product in x's dtype (TF32 off), float32, soft-capped, the padded vocab
    masked; a rank's shard gathers its vocab columns over "model"."""
    cfg = model.cfg
    x = model.final_norm(x)
    if cfg.tie_embeddings:
        lg = L.logits_from_embed(model.embed, x, cfg.logit_softcap)
    else:
        with L.full_f32():
            lg = L.softcap((x @ model.head_as(x.dtype)).float(), cfg.logit_softcap)
    if model.shard is not None:
        lg = collectives.gather(lg, model.shard.mesh, "model", lg.ndim - 1,
                                model.shard.vocab[0], cfg.vocab_padded)
    if cfg.vocab_padded > cfg.vocab:
        lg = lg + model.vocab_bias
    return lg


def prefill(model: TernaryLM, inputs: torch.Tensor, *, max_len: int | None = None,
            serve_sparse: bool = True):
    """Token ids (B, S), or float embeddings (B, S, D), which pass through
    in their own dtype -> (last-position logits (B, V) float32, caches)."""
    s = inputs.shape[1]
    x = inputs if inputs.is_floating_point() else _take_embed(model, inputs)
    x, caches = T.stack_prefill(model.layers, model.cfg, x, serve_sparse=serve_sparse,
                                max_len=max_len if max_len is not None else s + 1,
                                shared=model.shared)
    return _logits(model, x[:, -1:])[:, 0], caches


def decode_step(model: TernaryLM, caches: list, tokens: torch.Tensor,
                t: torch.Tensor, *, serve_sparse: bool = True,
                page_table: torch.Tensor | None = None,
                forced: torch.Tensor | None = None,
                forced_x: torch.Tensor | None = None):
    """One token per sequence: tokens (B,), positions t (B,).  The caches
    are updated in place and returned with the logits (B, V) float32.
    Paged arenas take ``page_table`` (B, pages_per_seq) int32, and rows
    with t = -1 are inactive.

    With ``forced`` (B,) bool and ``forced_x`` (B, D) float32 (a stub
    frontend's prompt rows still being fed), row b's input is forced_x[b]
    where forced[b], else its token's embedding in float32: the JAX
    engine's decode input for these models."""
    if forced is not None:
        emb = model.embed[tokens].to(forced_x.dtype)
        x = torch.where(forced[:, None], forced_x, emb)[:, None]
    else:
        x = _take_embed(model, tokens)[:, None]
    x = T.stack_decode(model.layers, model.cfg, x, caches, t,
                       serve_sparse=serve_sparse, page_table=page_table, shared=model.shared)
    return _logits(model, x)[:, 0], caches


def init_caches(cfg: ModelConfig, batch: int, max_len: int, *, device=None,
                dtype: torch.dtype | None = None, serve_sparse: bool = True,
                page_size: int = 0, num_pages: int = 0) -> list:
    """Empty decode caches, one dict per layer; ``page_size > 0`` makes each
    would-be full cache a paged arena of ``num_pages`` pages."""
    dt = dtype if dtype is not None else L.torch_dtype(cfg.dtype)
    return [KV.init_cache(cfg, T.layer_cache_spec(cfg, kind, batch, max_len, dt,
                                                  serve_sparse=serve_sparse,
                                                  page_size=page_size,
                                                  num_pages=num_pages), device)
            for kind in cfg.layer_kinds()]


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

def _inputs_to_x(p: dict, cfg: ModelConfig, batch_in: torch.Tensor) -> torch.Tensor:
    """Token ids -> their embeddings (gemma's scaled); float embeddings (a
    stub frontend's) pass through in their own dtype."""
    if batch_in.is_floating_point():
        return batch_in
    return L.take_embed(p["embed"], batch_in, scale=embed_scale(cfg))


def _train_logits(p: dict, cfg: ModelConfig, x: torch.Tensor, mesh=None,
                  lo: int = 0) -> torch.Tensor:
    """The final norm, the tied embedding's or the untied head's product in
    x's dtype, float32, soft-capped, the padded vocab at -1e30; on a vocab
    shard (``mesh``) the columns [lo, lo + n) of the rank's rows, padding
    found by their global ids."""
    x = collectives.copy_to_model(L.rmsnorm(p["final_norm"]["scale"], x), mesh)
    if cfg.tie_embeddings:
        lg = L.logits_from_embed(p["embed"], x, cfg.logit_softcap)
    else:
        lg = L.softcap(torch.matmul(x, p["head"].to(x.dtype)).float(), cfg.logit_softcap)
    if cfg.vocab_padded > cfg.vocab:
        pad = lo + torch.arange(lg.shape[-1], device=lg.device) >= cfg.vocab
        lg = lg + torch.where(pad, -1e30, 0.0)
    return lg


def _kv_replica_grads(p: dict, cfg: ModelConfig, mesh) -> dict:
    """``p`` with every wk / wv weight of a replicated kv head through
    ``collectives.sum_replicas``: each rank's gradient of it comes from its
    own q heads, so the ranks that hold the head sum theirs."""
    tp = mesh.topology.tp
    if kv_replicas(cfg, tp) == 1:
        return p
    lo = model_bounds(cfg, tp)["kv"][mesh.model_index][0]
    out = []
    for path, x in leaves_with_paths(p):
        names = path.split("/")
        if names[-1] == "w" and names[-2:-1] in (["wk"], ["wv"]):
            x = collectives.sum_replicas(x, mesh, x.ndim - 1, lo, cfg.kv_dim)
        out.append(x)
    return unflatten(p, out)


def _vocab_lo(cfg: ModelConfig, mesh) -> int:
    return model_bounds(cfg, mesh.topology.tp)["vocab"][mesh.model_index][0]


def forward(p: dict, cfg: ModelConfig, batch_in: torch.Tensor,
            rt: T.Runtime = T.Runtime()) -> torch.Tensor:
    """Whole-sequence training forward of a master tree: token ids (B, S)
    or float embeddings (B, S, D) -> logits (B, S, V) float32.  Under
    ``rt.model_mesh``, ``p`` is the rank's shard (``shard_params``) and the
    logits are its vocab columns (B, S, V / tp)."""
    mesh = rt.model_mesh
    if mesh is None:
        x = _inputs_to_x(p, cfg, batch_in)
        return _train_logits(p, cfg, T.stack_train(p["layers"], cfg, x, rt))
    check_shardable(cfg, mesh.topology.tp, training=True)
    lo = _vocab_lo(cfg, mesh)
    p = shard_scales(_kv_replica_grads(p, cfg, mesh), mesh)
    x = L.take_embed_shard(p["embed"], batch_in, lo, mesh, scale=embed_scale(cfg))
    x = T.stack_train(p["layers"], local_config(cfg, mesh), x, rt)
    return _train_logits(p, cfg, x, mesh, lo)


def _vocab_parallel_ce(lg: torch.Tensor, lab: torch.Tensor, mesh, lo: int):
    """(logsumexp, gold logit) of each row over the vocab cut across
    "model": the row max (a constant of autograd) and the sum of exp(lg -
    max) reduced over "model", the gold logit from the rank whose columns
    hold it."""
    with torch.no_grad():
        m = collectives.pmax(lg.amax(-1, keepdim=True), mesh, "model")
    s = collectives.reduce_from_model(torch.exp(lg - m).sum(-1, keepdim=True), mesh)
    lse = (m + torch.log(s))[..., 0]
    inside = (lab >= lo) & (lab < lo + lg.shape[-1])
    own = torch.gather(lg, -1, torch.where(inside, lab - lo, 0)[..., None])[..., 0]
    return lse, collectives.reduce_from_model(own * inside, mesh)


def loss_fn(p: dict, cfg: ModelConfig, batch: dict, rt: T.Runtime = T.Runtime()):
    """Next-token cross entropy of batch {"inputs", "labels"} (labels -1
    masked), logsumexp in float32, averaged over max(tokens, 1) -> (loss,
    {"loss", "tokens"}).  Under ``rt.mesh`` the batch is the rank's rows and
    the count is the whole batch's (summed over "dp"): the returned loss is
    the rank's part (the ranks' parts and gradients sum to the whole
    batch's), the aux "loss" the sum."""
    logits = forward(p, cfg, batch["inputs"], rt)
    labels = batch["labels"]
    mask = labels >= 0
    lab = torch.where(mask, labels, 0).long()
    if rt.model_mesh is None:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lab[..., None])[..., 0]
    else:
        lse, gold = _vocab_parallel_ce(logits, lab, rt.model_mesh, _vocab_lo(cfg, rt.model_mesh))
    nll = (lse - gold) * mask
    if rt.mesh is None:
        denom = torch.clamp(mask.sum(), min=1)
        loss = nll.sum() / denom
        return loss, {"loss": loss, "tokens": denom}
    denom = torch.clamp(collectives.psum(mask.sum().float(), rt.mesh, "dp"), min=1)
    loss = nll.sum() / denom
    return loss, {"loss": collectives.psum(loss.detach(), rt.mesh, "dp"), "tokens": denom}
