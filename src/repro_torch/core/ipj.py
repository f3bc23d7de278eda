"""IPJ — Intelligence Per Joule (paper Sec. I).

A copy of the JAX package's ``core/ipj.py``.

    IPJ = #tokens / (perplexity * Joule) = (tokens/s) / (perplexity * Watt)

1/PPL is the average per-token likelihood, so IPJ reads as "expected correct
tokens per Joule".  Used by the DSE objective and the Fig-1/2 benchmarks.
"""

from __future__ import annotations

__all__ = ["ipj", "ipj_from_latency"]


def ipj(tokens_per_s: float, perplexity: float, watts: float) -> float:
    if perplexity <= 0 or watts <= 0:
        raise ValueError("perplexity and watts must be positive")
    return tokens_per_s / (perplexity * watts)


def ipj_from_latency(num_tokens: int, latency_s: float, perplexity: float,
                     watts: float) -> float:
    """IPJ of a whole request: num_tokens generated in latency_s at watts."""
    if latency_s <= 0:
        raise ValueError("latency must be positive")
    return ipj(num_tokens / latency_s, perplexity, watts)
