"""AdamW with global-norm clipping, functional, as the JAX package orders it.

(params, grads, state) -> (params, state, {"grad_norm"}): float32 moments
for any parameter dtype; the clip scale multiplies the float32 gradient
(the JAX package's bfloat16 gradient times a float32 scale is float32);
bias corrections 1 - b ** t in float32; the update p - lr * (m_hat /
(sqrt(v_hat) + eps) + wd * p) in float32, cast to p's dtype.
``torch.optim.AdamW`` keeps a bfloat16 parameter's moments in bfloat16 and
rounds its decoupled decay otherwise, so it is not used.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.tree import leaves, tree_map, unflatten

__all__ = ["AdamWState", "adamw_init", "adamw_step", "global_norm"]


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32 scalar: steps taken
    m: Any               # float32 first moments, the params' tree
    v: Any               # float32 second moments


def adamw_init(params: Any) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    step = torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device)
    return AdamWState(step=step, m=tree_map(zeros, params), v=tree_map(zeros, params))


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf in float32, summed leaf by
    leaf in the JAX package's leaf order."""
    total = None
    for x in leaves(tree):
        s = torch.sum(torch.square(x.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def adamw_step(params: Any, grads: Any, state: AdamWState, *, lr, b1: float = 0.9,
               b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1,
               clip_norm: float | None = 1.0) -> tuple[Any, AdamWState, dict]:
    """One update, in a profiler range "adamw_step"."""
    with torch.profiler.record_function("adamw_step"):
        return _adamw_step(params, grads, state, lr, b1, b2, eps, weight_decay, clip_norm)


def _adamw_step(params, grads, state, lr, b1, b2, eps, weight_decay, clip_norm):
    gnorm = global_norm(grads)
    if clip_norm is not None:
        scale = torch.clamp(clip_norm / (gnorm + 1e-9), max=1.0)
        grads = tree_map(lambda g: g.float() * scale, grads)
    t = state.step + 1
    tf = t.float()
    b1c = 1.0 - torch.pow(b1, tf)
    b2c = 1.0 - torch.pow(b2, tf)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=tf.device)

    def upd(p, g, m, v):
        gf = g.float()
        m2 = b1 * m + (1 - b1) * gf
        v2 = b2 * v + (1 - b2) * gf * gf
        mh = m2 / b1c
        vh = v2 / b2c
        pf = p.float()
        step = mh / (torch.sqrt(vh) + eps) + weight_decay * pf
        return (pf - lr * step).to(p.dtype), m2, v2

    out = [upd(*xs) for xs in zip(leaves(params), leaves(grads), leaves(state.m),
                                  leaves(state.v))]
    pick = lambda i: unflatten(params, [o[i] for o in out])  # noqa: E731
    return pick(0), AdamWState(step=t, m=pick(1), v=pick(2)), {"grad_norm": gnorm}
