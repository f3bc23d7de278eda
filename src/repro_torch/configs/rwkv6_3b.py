"""RWKV6 (Finch) 3B [arXiv:2404.05892] — attention-free, data-dependent decay.

LPSA is inapplicable (no attention); per-token state is already O(1) — the
paper's own GLA experiment (Sec. V-D) is the template: ternary + DAS apply
to all projections. `lpsa=None` encodes the inapplicability.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, head_dim=64,
    d_ff=8960, vocab=65_536,
    layer_pattern=("rwkv",), lpsa=None, tie_embeddings=False,
)
