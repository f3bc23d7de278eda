"""Optimizer substrate: AdamW, learning-rate schedules, gradient accumulation."""
from . import adamw, grad, schedule  # noqa: F401
