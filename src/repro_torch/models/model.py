"""Public model API: TernaryLM, init / export, prefill, decode step, caches.

``init_params`` draws master weights from a seeded ``torch.Generator`` into
the JAX package's tree layout ({embed, final_norm, layers: {stacked, tail,
shared}} with {"w"} leaves, and a dense ``head`` when the embeddings are
untied); ``export_serving`` quantizes them to the
config's serve format (base-3 packed, or int8 trits) and loads the result
into a ``TernaryLM``.  ``TernaryLM.from_tree`` loads any serving tree in
that layout — the port's own export, or the JAX package's through
``repro_torch.bridge`` — leaf path by leaf path.  ``trits_from_packed``
turns a packed model into the int8-resident form on its device, through the
``twd_decode`` kernel.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import kvcache as KV
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.ternary_linear import (TRITS_FORMATS, TernaryLinear,
                                               export_tlin, tlin_init)

__all__ = ["TernaryLM", "init_params", "export_serving", "trits_from_packed",
           "flatten_tree", "prefill", "decode_step", "init_caches"]


class TernaryLM(nn.Module):
    """Serving weights of a dense ternary LM, on the CUDA device unless
    ``device="cpu"``: the embedding, the untied dense ``head`` (d_model,
    vocab_padded) where the config has one, the blocks and the final norm."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.frontend != "none":
            raise NotImplementedError("the port serves token-input models; "
                                      f"frontend {cfg.frontend!r} waits (ROADMAP)")
        dt = L.torch_dtype(cfg.dtype)
        device = resolve_device(device)
        self.cfg = cfg
        # the JAX package scales a dense gemma model's input embeddings
        self.embed_scale = cfg.family == "dense" and cfg.name.startswith("gemma")
        self.register_buffer("embed", torch.zeros((cfg.vocab_padded, cfg.d_model),
                                                  dtype=dt, device=device))
        if not cfg.tie_embeddings:
            self.register_buffer("head", torch.zeros((cfg.d_model, cfg.vocab_padded),
                                                     dtype=dt, device=device))
        self.final_norm = L.RMSNorm(cfg.d_model, dt, device)
        self.layers = nn.ModuleList(T.Block(cfg, kind, dt, device)
                                    for kind in cfg.layer_kinds())
        # logits past `vocab` are padding rows: masked out
        bias = torch.where(torch.arange(cfg.vocab_padded) < cfg.vocab, 0.0, -1e30)
        self.register_buffer("vocab_bias", bias.to(device), persistent=False)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @classmethod
    def from_tree(cls, tree: dict, cfg: ModelConfig, device=None) -> "TernaryLM":
        """A model on ``device`` holding the serving tree's tensors.

        Every buffer must have a leaf of its shape and dtype at its path, and
        every leaf a buffer; anything else raises."""
        model = cls(cfg, device)
        flat = flatten_tree(tree, cfg)
        own = model.state_dict()
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
        return model


def flatten_tree(tree: dict, cfg: ModelConfig) -> dict:
    """{module-style name: leaf} of a serving tree in the JAX package's
    layout; scan-stacked groups (leading group axis) are split per layer."""
    lay = tree["layers"]
    if lay.get("shared") is not None:
        raise NotImplementedError("shared attention blocks are not ported")
    blocks: list = []
    if lay.get("stacked") is not None:
        per_pos = lay["stacked"]
        groups = _leaves(per_pos[0])[0].shape[0]
        for g in range(groups):
            for pos_tree in per_pos:
                blocks.append(_map(lambda a, g=g: a[g], pos_tree))
    blocks.extend(lay["tail"])
    if len(blocks) != cfg.n_layers:
        raise ValueError(f"tree holds {len(blocks)} layers, {cfg.name} has "
                         f"{cfg.n_layers}")
    out: dict = {}
    top = {"embed": tree["embed"], "final_norm": tree["final_norm"]}
    if "head" in tree:
        top["head"] = tree["head"]
    _flatten(top, "", out)
    for i, b in enumerate(blocks):
        _flatten(b, f"layers.{i}.", out)
    return out


def _flatten(tree, prefix: str, out: dict) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}.", out)
    elif tree is not None:
        out[prefix[:-1]] = tree


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def init_params(cfg: ModelConfig, *, seed: int = 0, device=None) -> dict:
    """Seeded random master weights in cfg.dtype, one tree per layer."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dt = L.torch_dtype(cfg.dtype)
    d, qd, kvd, f = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff
    zeros = lambda: {"scale": torch.zeros(d, dtype=dt, device=dev)}  # noqa: E731

    def block() -> dict:
        return {
            "norm1": zeros(),
            "attn": {"wq": tlin_init(gen, d, qd, dt),
                     "wk": tlin_init(gen, d, kvd, dt),
                     "wv": tlin_init(gen, d, kvd, dt),
                     "wo": tlin_init(gen, qd, d, dt,
                                     scale=(qd * 2 * cfg.n_layers) ** -0.5)},
            "norm2": zeros(),
            "ffn": {"w_gate": tlin_init(gen, d, f, dt),
                    "w_in": tlin_init(gen, d, f, dt),
                    "w_out": tlin_init(gen, f, d, dt,
                                       scale=(f * 2 * cfg.n_layers) ** -0.5)},
        }

    embed = torch.randn((cfg.vocab_padded, d), generator=gen, device=dev) * 0.02
    tree = {"embed": embed.to(dt), "final_norm": zeros(),
            "layers": {"stacked": None,
                       "tail": tuple(block() for _ in cfg.layer_kinds()),
                       "shared": None}}
    if not cfg.tie_embeddings:
        head = torch.randn((d, cfg.vocab_padded), generator=gen, device=dev) * 0.02
        tree["head"] = head.to(dt)
    return tree


def export_serving(params: dict, cfg: ModelConfig) -> TernaryLM:
    """Master weights -> a TernaryLM whose ternary linears take the config's
    serve format (TWD-packed or int8 trits), on the master weights' device."""
    def conv(tree):
        if isinstance(tree, dict):
            if "w" in tree:
                return export_tlin(tree, cfg.ternary)
            return {k: conv(v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(conv(v) for v in tree)
        return tree
    return TernaryLM.from_tree(conv(params), cfg, params["embed"].device)


def trits_from_packed(packed: TernaryLM, cfg: ModelConfig) -> TernaryLM:
    """The int8-resident serving form of a packed model, on its device.

    ``cfg`` has the packed model's shapes and serve format "int8" or "bf16"
    (its DAS and LPSA settings may differ).  Every linear's trits are
    ``ops.twd_decode`` of its packed weights, cut to d_in rows; the scales,
    norms and embeddings are copied."""
    if cfg.ternary.serve_format not in TRITS_FORMATS:
        raise ValueError(f"serve_format {cfg.ternary.serve_format!r} holds no trits")
    out = TernaryLM(cfg, packed.device)
    src = packed.state_dict()
    lins = {name: m for name, m in packed.named_modules()
            if isinstance(m, TernaryLinear)}
    for name, buf in out.state_dict().items():
        mod, _, leaf = name.rpartition(".")
        val = (ops.twd_decode(lins[mod].packed, buf.shape[0]) if leaf == "trits"
               else src[name])
        if val.shape != buf.shape:
            raise ValueError(f"{name}: packed model gives {tuple(val.shape)}, "
                             f"{cfg.name} wants {tuple(buf.shape)}")
        buf.copy_(val)
    return out


def _logits(model: TernaryLM, x: torch.Tensor) -> torch.Tensor:
    """The final norm, then the tied embedding's or the untied head's
    product in x's dtype, float32, soft-capped, the padded vocab masked."""
    cfg = model.cfg
    x = model.final_norm(x)
    if cfg.tie_embeddings:
        lg = L.logits_from_embed(model.embed, x, cfg.logit_softcap)
    else:
        lg = L.softcap((x @ model.head.to(x.dtype)).float(), cfg.logit_softcap)
    if cfg.vocab_padded > cfg.vocab:
        lg = lg + model.vocab_bias
    return lg


def prefill(model: TernaryLM, tokens: torch.Tensor, *, max_len: int | None = None,
            serve_sparse: bool = True):
    """tokens (B, S) -> (last-position logits (B, V) float32, caches)."""
    s = tokens.shape[1]
    x = L.take_embed(model.embed, tokens, scale=model.embed_scale)
    x, caches = T.stack_prefill(model.layers, model.cfg, x, serve_sparse=serve_sparse,
                                max_len=max_len if max_len is not None else s + 1)
    return _logits(model, x[:, -1:])[:, 0], caches


def decode_step(model: TernaryLM, caches: list, tokens: torch.Tensor,
                t: torch.Tensor, *, serve_sparse: bool = True,
                page_table: torch.Tensor | None = None):
    """One token per sequence: tokens (B,), positions t (B,).  The caches
    are updated in place and returned with the logits (B, V) float32.
    Paged arenas take ``page_table`` (B, pages_per_seq) int32, and rows
    with t = -1 are inactive."""
    x = L.take_embed(model.embed, tokens, scale=model.embed_scale)[:, None]
    x = T.stack_decode(model.layers, model.cfg, x, caches, t,
                       serve_sparse=serve_sparse, page_table=page_table)
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
