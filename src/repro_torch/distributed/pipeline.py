"""Pipeline parallelism over the "pod" axis: the JAX package's GPipe
schedule on explicit per-rank stages.

Each rank of the pod axis holds one stage (its ``stage_params``);
``pipeline_apply`` splits the batch into M microbatches and runs them
through S stages in T = M + S - 1 ticks: stage s takes microbatch j at
tick s + j, stage 0 injecting it and every other stage receiving it from
the one before; the last stage's outputs are summed to every rank of the
axis (the others contribute zeros).  A stage is idle outside its M ticks
(the bubble, 1 - M / T of the schedule): the JAX package computes its
stages there on zeros whose results it drops, this port skips them, so the
outputs are the same.

The activation hop is an autograd Function over ``collectives.send`` /
``recv``: forward it sends a stage's output to the next stage, backward the
next stage sends the gradient of that activation back (the transpose of the
JAX package's ``ppermute``).  The receiving side takes the stage's
parameters as inputs and the sending side's output is tied into the result
by a zero-weighted token, so ``torch.autograd.grad`` of a loss of the
result towards the stages' parameters runs every hop's backward on both
ranks, in the reverse of the forward's order.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.distributed import collectives
from repro_torch.tree import leaves

__all__ = ["split_stages", "pipeline_apply"]


def split_stages(seq: tuple, n_stages: int) -> tuple:
    """Split a tuple of layer params into ``n_stages`` contiguous chunks."""
    n = len(seq)
    per = (n + n_stages - 1) // n_stages
    return tuple(seq[i * per:(i + 1) * per] for i in range(n_stages))


class _Send(torch.autograd.Function):
    """Forward: send y to stage ``to``, return a zero token that carries the
    hop into the output; backward: receive y's gradient from ``to``."""

    @staticmethod
    def forward(ctx, y, mesh, axis, to):
        ctx.mesh, ctx.axis, ctx.to, ctx.like = mesh, axis, to, torch.empty_like(y)
        collectives.send(y, mesh, axis, to)
        return y.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        return collectives.recv(ctx.like, ctx.mesh, ctx.axis, ctx.to), None, None, None


class _Recv(torch.autograd.Function):
    """Forward: receive an activation like ``like`` from stage ``frm``;
    backward: send its gradient back.  The stage's parameters are its
    inputs (their gradients from it are none), so ``torch.autograd.grad``
    towards them runs this backward, which the stage before waits for."""

    @staticmethod
    def forward(ctx, like, mesh, axis, frm, *anchors):
        ctx.mesh, ctx.axis, ctx.frm, ctx.n = mesh, axis, frm, len(anchors)
        return collectives.recv(like, mesh, axis, frm)

    @staticmethod
    def backward(ctx, g):
        collectives.send(g.contiguous(), ctx.mesh, ctx.axis, ctx.frm)
        return (None,) * (4 + ctx.n)


def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor, *, mesh,
                   axis: str = "pod", n_microbatches: int = 4) -> torch.Tensor:
    """x (B, ...) through the S stages of ``axis`` -> y of x's shape on every
    rank of the axis; ``stage_fn(stage_params, x_mb) -> y_mb`` keeps a
    microbatch's shape, ``stage_params`` is this rank's stage.  Every rank
    of the axis calls it with the same x (only stage 0 reads it)."""
    s_n, sid = mesh.size(axis), mesh.index(axis)
    m = n_microbatches
    b = x.shape[0]
    if b % m:
        raise ValueError(f"batch {b} not divisible by microbatches {m}")
    mbs = x.reshape((m, b // m) + tuple(x.shape[1:]))
    anchors = [t for t in leaves(stage_params) if t.requires_grad]
    tokens, outs = [], []
    for tick in range(m + s_n - 1):
        j = tick - sid                      # the microbatch this stage runs at this tick
        if not 0 <= j < m:
            continue                        # the bubble
        x_in = mbs[j] if sid == 0 else _Recv.apply(mbs[j], mesh, axis, sid - 1, *anchors)
        y = stage_fn(stage_params, x_in)
        if sid < s_n - 1:
            tokens.append(_Send.apply(y, mesh, axis, sid + 1))
        else:
            outs.append(y)
        if sid > 0:
            tokens.append(x_in.sum() * 0)   # the hop's backward runs even if y is unused
    local = torch.stack(outs) if outs else torch.zeros_like(mbs)
    local = local + torch.stack(tokens).sum() * 0 if tokens else local
    y = collectives.reduce_from(local.float(), mesh, axis).to(x.dtype)
    return y.reshape(x.shape)
