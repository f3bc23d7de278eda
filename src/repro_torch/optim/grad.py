"""Gradient accumulation over microbatches (one device).

The JAX package's ``compressed_crosspod_mean`` (the int8 error-feedback
exchange across pods) waits for the training half of the distributed
slice (ROADMAP queue 1, item 2).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.tree import leaves, tree_map, unflatten

__all__ = ["accumulate_grads"]


def accumulate_grads(loss_fn: Callable, params: Any, batches: Any,
                     n_micro: int) -> tuple[torch.Tensor, Any, None]:
    """Mean loss and float32 gradients over ``n_micro`` microbatches: every
    leaf of ``batches`` has a leading n_micro axis, ``loss_fn(params, mb)``
    -> (loss, aux), and the floating leaves of ``params`` require grad.
    The gradients add up in float32 one microbatch after another and are
    divided by n_micro at the end, as the JAX package's scan does."""
    flat = leaves(params)
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in flat]
    losses = []
    for i in range(n_micro):
        loss, _ = loss_fn(params, tree_map(lambda b: b[i], batches))
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        acc = [a if g is None else a + g for a, g in zip(acc, grads)]
        losses.append(loss.detach())
    grads = unflatten(params, [a / n_micro for a in acc])
    return torch.stack(losses).mean(), grads, None
