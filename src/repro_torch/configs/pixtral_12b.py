"""Pixtral-12B [hf:mistralai/Pixtral-12B-2409] — ViT frontend + nemo decoder.

Backbone only: the Pixtral-ViT is a stub, so a prompt is its precomputed
patch embeddings interleaved with text embeddings, float32 (P, d_model).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=160,
    d_ff=14_336, vocab=131_072, rope_theta=1_000_000.0,
    frontend="vision_patches", tie_embeddings=False,
)
