"""Config schema: model architecture + TENET feature flags + run shapes.

A copy of the JAX package's `repro/configs/base.py`: the port imports
nothing of that package, so it keeps its own schema (field for field).

One frozen dataclass tree describes every architecture in the zoo; the TENET
techniques (ternary linears, DAS, TWD, LPSA) are first-class switches that
compose with any family.  `reduced()` derives the CPU smoke-test variant of a
config (same family/pattern, tiny dims).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Literal

__all__ = [
    "DasConfig", "LpsaConfig", "TernaryConfig", "MoeConfig", "SsmConfig",
    "ModelConfig", "reduced",
]

Family = Literal["dense", "moe", "hybrid", "ssm", "audio", "vlm"]
# per-layer mixer kinds used in `layer_pattern`
Mixer = Literal["attn", "local", "mamba", "rwkv", "gla"]


@dataclass(frozen=True)
class DasConfig:
    """Dynamic Activation N:M sparsity (paper Sec. III-C)."""
    block: int = 32
    keep: int = 16            # S_a = keep / block

    @property
    def s_a(self) -> float:
        return self.keep / self.block


@dataclass(frozen=True)
class LpsaConfig:
    """Sink+window sparse attention + pack-fused dataflow (Sec. IV-B)."""
    sink: int = 128
    window: int = 896         # TL_SA = sink + window = 1024 (paper)
    chunk: int = 256          # pack size C

    @property
    def tl_sa(self) -> int:
        return self.sink + self.window


@dataclass(frozen=True)
class TernaryConfig:
    """Ternary linear-layer stack: QAT + serving format (Secs. III-B/E)."""
    enabled: bool = True
    das: DasConfig | None = field(default_factory=DasConfig)
    twd: bool = True                   # serve weights base-3 packed (1.6 b/w)
    serve_format: Literal["packed", "int8", "bf16"] = "packed"


@dataclass(frozen=True)
class MoeConfig:
    n_experts: int = 128
    top_k: int = 8
    d_expert: int = 768
    n_shared: int = 0                  # shared (always-on) experts
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclass(frozen=True)
class SsmConfig:
    """Mamba2 SSD block dims."""
    state_dim: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256                   # SSD chunk length


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None        # None => d_model // n_heads
    # repeating per-layer mixer pattern; len(pattern) divides layers or the
    # remainder forms an unrolled tail (e.g. gemma3's 5 local : 1 global).
    layer_pattern: tuple[str, ...] = ("attn",)
    window: int = 4096                 # local-attention window width
    attn_softcap: float | None = None
    logit_softcap: float | None = None
    rope_theta: float = 10_000.0
    tie_embeddings: bool = True
    act: str = "silu"
    ffn_kind: str = "gated"     # gated (3-mat GLU) | mlp (2-mat)
    # family extensions
    moe: MoeConfig | None = None
    ssm: SsmConfig | None = None
    shared_attn: bool = False          # zamba2: one attn block's weights shared
    frontend: Literal["none", "audio_frames", "vision_patches"] = "none"
    # TENET features
    ternary: TernaryConfig = field(default_factory=TernaryConfig)
    lpsa: LpsaConfig | None = field(default_factory=LpsaConfig)
    # numerics / runtime
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True

    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Embedding rows padded to 128 (16-way TP + MXU lane alignment);
        logits beyond `vocab` are masked (the Megatron vocab-pad recipe)."""
        return ((self.vocab + 127) // 128) * 128

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim_

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim_

    @property
    def attention_free(self) -> bool:
        return all(p in ("mamba", "rwkv", "gla") for p in self.layer_pattern)

    def layer_kinds(self) -> tuple[str, ...]:
        p = self.layer_pattern
        return tuple(p[i % len(p)] for i in range(self.n_layers))

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, kinds = self.d_model, self.layer_kinds()
        total = self.vocab * d * (1 if self.tie_embeddings else 2)
        for kind in kinds:
            if kind in ("attn", "local"):
                total += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            elif kind == "mamba":
                s = self.ssm or SsmConfig()
                di = s.expand * d
                total += d * (2 * di + 2 * s.state_dim + di // s.head_dim) + di * d
            elif kind in ("rwkv", "gla"):
                total += 5 * d * d
            if self.moe is not None:
                e = self.moe
                total += d * e.n_experts  # router
                total += (e.n_experts + e.n_shared) * 3 * d * e.d_expert
            elif kind != "mamba":  # mamba blocks in zamba/mamba have no sep. FFN
                total += 3 * d * self.d_ff if self.act == "silu" else 2 * d * self.d_ff
        return total


def reduced(cfg: ModelConfig, *, n_layers: int | None = None,
            d_model: int = 64, vocab: int = 512) -> ModelConfig:
    """Smoke-test variant: same family & pattern, tiny dims (CPU-runnable)."""
    pat = len(cfg.layer_pattern)
    nl = n_layers if n_layers is not None else max(pat, 2 if pat == 1 else pat)
    hd = 16
    n_kv = max(1, min(2, cfg.n_kv_heads))
    n_heads = max(n_kv, 4 if cfg.n_heads >= 4 else cfg.n_heads)
    kw: dict = dict(
        name=cfg.name + "-smoke", n_layers=nl, d_model=d_model,
        n_heads=n_heads, n_kv_heads=n_kv, head_dim=hd,
        d_ff=d_model * 2, vocab=vocab, window=32,
        lpsa=None if cfg.lpsa is None else LpsaConfig(sink=8, window=24, chunk=16),
        ternary=replace(cfg.ternary,
                        das=None if cfg.ternary.das is None else DasConfig(32, 16)),
        remat=False, scan_layers=False, dtype="float32",
    )
    if cfg.moe is not None:
        # capacity_factor = E/top_k  =>  capacity == token count: no drops,
        # so forward == prefill+decode exactly in the smoke tests.
        kw["moe"] = MoeConfig(n_experts=8, top_k=2, d_expert=d_model * 2,
                              n_shared=cfg.moe.n_shared and 1,
                              capacity_factor=4.0)
    if cfg.ssm is not None:
        kw["ssm"] = SsmConfig(state_dim=16, head_dim=16, expand=2,
                              conv_width=4, chunk=16)
    return dataclasses.replace(cfg, **kw)
