"""Architecture registry of the port: `get_config("<arch-id>")` / `--arch <id>`.

Every architecture of the JAX package's registry is registered: the
paper's own bitnet models, the dense models of its zoo, its two MoE models
(kimi-k2 reduced only: ROADMAP queue 1), its two attention-free SSMs,
rwkv6-3b and gla-1.3b, the hybrid zamba2-2.7b (Mamba2 blocks and one shared
attention block), and the two stub-frontend models, musicgen-medium (2-matrix
gelu MLP) and pixtral-12b (head size 160), whose prompts are float32
embeddings (``models.model.uses_embeds``).
"""

from __future__ import annotations

from importlib import import_module

from .base import ModelConfig, reduced  # noqa: F401

ARCH_MODULES = {
    "gemma2-2b": "gemma2_2b",
    "minicpm-2b": "minicpm_2b",
    "gemma3-1b": "gemma3_1b",
    "stablelm-1.6b": "stablelm_1p6b",
    "bitnet-3b": "bitnet_3b",
    "bitnet-1.3b": "bitnet_1p3b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "rwkv6-3b": "rwkv6_3b",
    "gla-1.3b": "gla_1p3b",
    "zamba2-2.7b": "zamba2_2p7b",
    "musicgen-medium": "musicgen_medium",
    "pixtral-12b": "pixtral_12b",
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port serves "
                       f"{sorted(ARCH_MODULES)}")
    return import_module(f"repro_torch.configs.{ARCH_MODULES[arch]}").CONFIG
