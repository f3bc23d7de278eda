"""Gemma2-2B [arXiv:2408.00118] — local/global alternating, logit softcaps."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b", family="dense",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=9216, vocab=256_000,
    layer_pattern=("local", "attn"), window=4096,
    attn_softcap=50.0, logit_softcap=30.0,
    act="gelu", tie_embeddings=True,
)
