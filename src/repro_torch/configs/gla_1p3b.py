"""GLA-1.3B (paper Sec. V-D / Table III) — gated linear attention + TQ + DAS."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gla-1.3b", family="ssm",
    n_layers=24, d_model=2048, n_heads=4, n_kv_heads=4, head_dim=512,
    d_ff=5632, vocab=32_000,
    layer_pattern=("gla",), lpsa=None, tie_embeddings=False,
)
