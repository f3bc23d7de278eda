"""Gemma3-1B [hf:google/gemma-3-1b-pt] — 5:1 local:global, 128k context."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
    d_ff=6912, vocab=262_144,
    layer_pattern=("local", "local", "local", "local", "local", "attn"),
    window=512, rope_theta=1_000_000.0,
    act="gelu", tie_embeddings=True,
)
