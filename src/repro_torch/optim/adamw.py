"""AdamW with global-norm clipping, functional, as the JAX package orders it.

(params, grads, state) -> (params, state, {"grad_norm"}): float32 moments
for any parameter dtype; the clip scale multiplies the float32 gradient
(the JAX package's bfloat16 gradient times a float32 scale is float32);
bias corrections 1 - b ** t in float32; the update p - lr * (m_hat /
(sqrt(v_hat) + eps) + wd * p) in float32, cast to p's dtype.
``torch.optim.AdamW`` keeps a bfloat16 parameter's moments in bfloat16 and
rounds its decoupled decay otherwise, so it is not used.

ZeRO-1 (``ZeroLayout``, a rank's leaves on a ``distributed.plan.Mesh``):
the moments of a leaf that ``ShardingPlan.zero1`` cuts along "data" hold
the rank's slice of that dim; its gradient is reduce-scattered over "data"
(float32, every such leaf in one exchange; then summed over "pod" where
there are pods), AdamW updates the rank's slice, and each updated slice is
all-gathered over "data" as soon as it is updated (one exchange a leaf, so
a rank holds at most one leaf twice).  The update consumes the gradients:
each leaf's storage is released once it is copied into the exchange
buffer, so a rank never holds a second gradient tree.  A leaf that zero1 leaves
unsharded has its gradient summed over "dp" and is updated whole.  The
global norm counts each logical element once: the squares of the leaves
that "model" cuts summed over "model", the replicated ones (norm scales)
taken once, then the ZeRO slices summed over "data", so every rank clips by
the same factor.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from repro_torch.distributed import collectives
from repro_torch.tree import leaves, tree_map, unflatten

__all__ = ["AdamWState", "ZeroLayout", "adamw_init", "adamw_step", "global_norm"]


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32 scalar: steps taken
    m: Any               # float32 first moments, the params' tree
    v: Any               # float32 second moments


@dataclass(frozen=True)
class ZeroLayout:
    """A rank's leaves (``leaves`` order) under ZeRO-1 on ``mesh``: ``dims[i]``
    the dim whose "data" cut leaf i's moments hold (None: leaf i is updated
    whole), ``sharded[i]`` whether "model" cuts leaf i, ``replicas[i]`` how
    many ranks of "model" hold its cut (a replicated kv head; empty: 1
    each)."""
    mesh: Any
    dims: tuple
    sharded: tuple
    replicas: tuple = ()

    def bounds(self, size: int) -> tuple[int, int]:
        """The rank's [lo, hi) of a dim of ``size`` cut over "data"."""
        from repro_torch.distributed.plan import data_bounds
        return data_bounds(size, self.mesh.size("data"), self.mesh.data_index)

    def cut(self, tree: Any) -> Any:
        """Each leaf of a tree of the params' structure cut to the rank's
        "data" slice (a view)."""
        def one(x, dim):
            if dim is None:
                return x
            lo, hi = self.bounds(x.shape[dim])
            return x.narrow(dim, lo, hi - lo)
        return unflatten(tree, [one(x, d) for x, d in zip(leaves(tree), self.dims)])

    def gather(self, tree: Any) -> Any:
        """The inverse of ``cut``: each slice all-gathered over "data"."""
        def one(x, dim):
            if dim is None:
                return x
            full = collectives.all_gather(x.movedim(dim, 0), self.mesh, "data")
            return full.movedim(0, dim).contiguous()
        return unflatten(tree, [one(x, d) for x, d in zip(leaves(tree), self.dims)])


def adamw_init(params: Any, zero: ZeroLayout | None = None) -> AdamWState:
    """Zero moments in float32, of each leaf's shape or, under ``zero``, of
    the rank's slice."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    step = torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device)
    own = params if zero is None else zero.cut(params)
    return AdamWState(step=step, m=tree_map(zeros, own), v=tree_map(zeros, own))


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
               clip_norm: float | None = 1.0, zero: ZeroLayout | None = None
               ) -> tuple[Any, AdamWState, dict]:
    """One update, in a profiler range "adamw_step"; under ``zero`` the
    rank's ZeRO-1 update from its unreduced gradients, which it consumes
    (module docstring)."""
    with torch.profiler.record_function("adamw_step"):
        if zero is None:
            return _adamw_step(params, grads, state, lr, b1, b2, eps, weight_decay, clip_norm)
        return _zero_step(params, grads, state, lr, b1, b2, eps, weight_decay, clip_norm, zero)


def _bias(state, b1, b2, lr):
    t = state.step + 1
    tf = t.float()
    lr = torch.as_tensor(lr, dtype=torch.float32, device=tf.device)
    return t, 1.0 - torch.pow(b1, tf), 1.0 - torch.pow(b2, tf), lr


def _update(p, g, m, v, *, lr, b1, b2, b1c, b2c, eps, weight_decay):
    gf = g.float()
    m2 = b1 * m + (1 - b1) * gf
    v2 = b2 * v + (1 - b2) * gf * gf
    mh = m2 / b1c
    vh = v2 / b2c
    pf = p.float()
    step = mh / (torch.sqrt(vh) + eps) + weight_decay * pf
    return (pf - lr * step).to(p.dtype), m2, v2


def _clip_scale(gnorm, clip_norm):
    return None if clip_norm is None else torch.clamp(clip_norm / (gnorm + 1e-9), max=1.0)


def _adamw_step(params, grads, state, lr, b1, b2, eps, weight_decay, clip_norm):
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, clip_norm)
    if scale is not None:
        grads = tree_map(lambda g: g.float() * scale, grads)
    t, b1c, b2c, lr = _bias(state, b1, b2, lr)
    kw = dict(lr=lr, b1=b1, b2=b2, b1c=b1c, b2c=b2c, eps=eps, weight_decay=weight_decay)
    out = [_update(*xs, **kw) for xs in zip(leaves(params), leaves(grads), leaves(state.m),
                                            leaves(state.v))]
    pick = lambda i: unflatten(params, [o[i] for o in out])  # noqa: E731
    return pick(0), AdamWState(step=t, m=pick(1), v=pick(2)), {"grad_norm": gnorm}


def _split(flat: torch.Tensor, shapes: list) -> list:
    """``flat`` cut into views of ``shapes``, in order."""
    sizes = [math.prod(s) for s in shapes]
    return [c.view(s) for c, s in zip(torch.split(flat, sizes), shapes)]


def _summed(grads: list, dims: tuple, mesh, n_data: int) -> list:
    """Each leaf's gradient summed over the data axes, in float32: a
    ZeRO-cut leaf (``dims[i]`` set) only its rank's slice, along that dim;
    one reduce-scatter over "data" for all of them (row r of the float32
    buffer holds every leaf's rank-r slice), then the sum over "pod"; the
    other leaves whole, in one all-reduce over "dp".  Each gradient's
    storage is released once it is copied into its buffer."""
    out = [None] * len(grads)
    zi = [i for i, d in enumerate(dims) if d is not None]
    wi = [i for i, d in enumerate(dims) if d is None]
    dev = grads[0].device
    if zi:
        shapes = [(grads[i].shape[dims[i]] // n_data,) + tuple(grads[i].movedim(dims[i], 0)
                                                              .shape[1:]) for i in zi]
        rows = torch.empty((n_data, sum(math.prod(s) for s in shapes)), dtype=torch.float32,
                           device=dev)
        off = 0
        for i, s in zip(zi, shapes):
            k = math.prod(s)
            rows[:, off:off + k].copy_(grads[i].movedim(dims[i], 0).reshape(n_data, k))
            grads[i].set_()
            off += k
        mine = collectives.reduce_scatter(rows.view(-1), mesh, "data")
        del rows
        mine = collectives.psum(mine, mesh, "pod")
        for i, x in zip(zi, _split(mine, shapes)):
            out[i] = x.movedim(0, dims[i])
    if wi:
        shapes = [tuple(grads[i].shape) for i in wi]
        flat = torch.cat([grads[i].reshape(-1).float() for i in wi])
        for i in wi:
            grads[i].set_()
        flat = collectives.psum(flat, mesh, "dp")
        for i, x in zip(wi, _split(flat, shapes)):
            out[i] = x
    return out


def _zero_step(params, grads, state, lr, b1, b2, eps, weight_decay, clip_norm, zero):
    mesh, n_data = zero.mesh, zero.mesh.size("data")
    own = _summed(leaves(grads), zero.dims, mesh, n_data)
    # the global norm: each logical element once (module docstring); a cut
    # that r ranks of "model" hold counts 1/r on each
    sq = [torch.sum(torch.square(g)) for g in own]
    sq = [s / r for s, r in zip(sq, zero.replicas)] if any(r > 1 for r in zero.replicas) \
        else sq
    zero_t = torch.zeros((), device=sq[0].device)
    pick = lambda keep: sum((s for i, s in enumerate(sq) if keep(i)), zero_t)  # noqa: E731
    model = collectives.psum(torch.stack([
        pick(lambda i: zero.dims[i] is not None and zero.sharded[i]),
        pick(lambda i: zero.dims[i] is None and zero.sharded[i])]), mesh, "model")
    data = collectives.psum(model[0] + pick(lambda i: zero.dims[i] is not None
                                            and not zero.sharded[i]), mesh, "data")
    gnorm = torch.sqrt(data + model[1] + pick(lambda i: zero.dims[i] is None
                                              and not zero.sharded[i]))
    scale = _clip_scale(gnorm, clip_norm)
    t, b1c, b2c, lr = _bias(state, b1, b2, lr)
    kw = dict(lr=lr, b1=b1, b2=b2, b1c=b1c, b2c=b2c, eps=eps, weight_decay=weight_decay)
    new, m, v = [], [], []
    for i, (p, m0, v0) in enumerate(zip(leaves(zero.cut(params)), leaves(state.m),
                                         leaves(state.v))):
        g, own[i] = own[i], None
        p, m1, v1 = _update(p, g if scale is None else g * scale, m0, v0, **kw)
        del g
        d = zero.dims[i]
        if d is not None:
            p = collectives.all_gather(p.movedim(d, 0), mesh, "data").movedim(0, d).contiguous()
        new.append(p)
        m.append(m1)
        v.append(v1)
    return (unflatten(params, new),
            AdamWState(step=t, m=unflatten(state.m, m), v=unflatten(state.v, v)),
            {"grad_norm": gnorm})
