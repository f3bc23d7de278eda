"""Gradient machinery: accumulation over microbatches (per rank), and the
int8-compressed cross-pod exchange.

``accumulate_grads`` microbatches one batch on a rank.  ``compressed_crosspod_mean``
is the JAX package's error-feedback int8 mean over the "pod" axis only
(``distributed.collectives.compressed_psum``, leaf by leaf): the link
between pods is the thin pipe, so a pod reduces in full precision within
itself and ships int8 plus one float32 scale a leaf across pods, the
quantization residual carried to the next step by the caller's error tree.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.distributed import collectives
from repro_torch.tree import leaves, tree_map, unflatten

__all__ = ["accumulate_grads", "zeros_error", "compressed_crosspod_mean"]


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


def zeros_error(grads: Any) -> Any:
    """The error-feedback tree of ``grads``: float32 zeros of its shapes."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)


def compressed_crosspod_mean(grads: Any, error: Any, mesh,
                             pod_axis: str = "pod") -> tuple[Any, Any]:
    """The int8 error-feedback mean of each pod's gradients across
    ``pod_axis`` -> (mean tree, new error tree).  ``grads`` are a pod's
    partial means (its batch rows, its loss averaged within the pod), the
    same on every rank of the pod; ``mesh`` a ``plan.Mesh``."""
    n_pods = mesh.size(pod_axis)
    out = [collectives.compressed_psum(g, mesh, pod_axis, e)
           for g, e in zip(leaves(grads), leaves(error))]
    return (unflatten(grads, [s / n_pods for s, _ in out]),
            unflatten(error, [e for _, e in out]))
