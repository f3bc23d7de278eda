"""Zamba2-2.7B [arXiv:2411.15242] — Mamba2 backbone + shared attention blocks.

Pattern: five Mamba2 blocks then one (weight-shared) attention block; the
single attention block's parameters are reused at every attn position
(`shared_attn=True`), matching Zamba's shared-block design.
"""
from .base import ModelConfig, SsmConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=10_240, vocab=32_000,
    layer_pattern=("mamba", "mamba", "mamba", "mamba", "mamba", "attn"),
    ssm=SsmConfig(state_dim=64, head_dim=64, expand=2, conv_width=4),
    shared_attn=True, tie_embeddings=True,
)
