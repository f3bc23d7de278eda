"""BitNet-3B (paper's own model, Table II) — ternary LLaMA-like."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="bitnet-3b", family="dense",
    n_layers=26, d_model=3200, n_heads=32, n_kv_heads=32, head_dim=100,
    d_ff=8640, vocab=32_000, tie_embeddings=True,
)
