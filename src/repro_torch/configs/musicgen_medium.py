"""MusicGen-medium [arXiv:2306.05284] — decoder-only over EnCodec tokens.

Backbone only: the EnCodec frontend is a stub, so a prompt is its
precomputed frame embeddings, float32 (P, d_model).  Cross-attention
conditioning omitted (the backbone spec lists self-attention dims only).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, head_dim=64,
    d_ff=6144, vocab=2048, act="gelu", ffn_kind="mlp",
    frontend="audio_frames", tie_embeddings=False,
)
