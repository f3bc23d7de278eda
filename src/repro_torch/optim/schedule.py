"""Learning-rate schedules: linear warmup, then cosine or WSD.

WSD (warmup-stable-decay) is MiniCPM's schedule (arXiv:2404.06395), which
the minicpm-2b config trains with; cosine is the default elsewhere.  Both
take the step as an int or a tensor and return a float32 scalar tensor on
its device, computed in float32 as the JAX package computes it.
"""

from __future__ import annotations

import math

import torch

__all__ = ["cosine_schedule", "wsd_schedule"]


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_schedule(step, *, peak_lr: float, warmup: int, total: int,
                    final_frac: float = 0.1) -> torch.Tensor:
    s = _f32(step)
    warm = peak_lr * s / max(warmup, 1)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(s < warmup, warm, peak_lr * cos)


def wsd_schedule(step, *, peak_lr: float, warmup: int, total: int,
                 decay_frac: float = 0.1, final_frac: float = 0.01) -> torch.Tensor:
    """Warmup -> stable plateau -> short exponential decay tail."""
    s = _f32(step)
    decay_steps = max(int(total * decay_frac), 1)
    decay_start = total - decay_steps
    warm = peak_lr * s / max(warmup, 1)
    tail_prog = torch.clamp((s - decay_start) / decay_steps, 0.0, 1.0)
    tail = peak_lr * torch.pow(final_frac, tail_prog)
    out = torch.where(s < warmup, warm, peak_lr)
    return torch.where(s > decay_start, tail, out)
