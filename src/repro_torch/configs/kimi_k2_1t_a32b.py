"""Kimi K2 1T-A32B [arXiv:2501.kimi2] — trillion-param MoE, 384e top-8.

As in the JAX package's config, all 61 layers are MoE (the real K2 has one
dense lead layer), so the stack is uniform.  The port serves it reduced
only: its packed experts (~206 GB) do not fit one card, and its head size
of 112 is not one the attention kernel is built for (ROADMAP).
"""
from .base import ModelConfig, MoeConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=112,
    d_ff=2048,  # expert intermediate dim
    vocab=163_840,
    moe=MoeConfig(n_experts=384, top_k=8, d_expert=2048, n_shared=1),
    rope_theta=50_000.0, tie_embeddings=False,
)
