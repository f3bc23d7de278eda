"""BitNet-1.3B (paper's own model, Table II)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="bitnet-1.3b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=5460, vocab=32_000, tie_embeddings=True,
)
