"""Qwen3-MoE-30B-A3B [hf:Qwen/Qwen3-30B-A3B] — 128-expert top-8 MoE."""
from .base import ModelConfig, MoeConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=64,
    d_ff=768,  # = expert intermediate dim (all FFNs are MoE)
    vocab=151_936,
    moe=MoeConfig(n_experts=128, top_k=8, d_expert=768, n_shared=0),
    rope_theta=1_000_000.0, tie_embeddings=False,
)
