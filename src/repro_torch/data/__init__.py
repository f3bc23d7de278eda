"""Deterministic, step-keyed token streams (numpy)."""
from .pipeline import FileTokens, Prefetcher, SyntheticLM, make_batch_fn  # noqa: F401
