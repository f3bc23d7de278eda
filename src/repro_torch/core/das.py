"""DAS — Dynamic Activation N:M Sparsity (paper Sec. III-C), on tensors.

Per token the hidden axis splits into blocks of ``block_size`` lanes; inside
each block the ``keep`` largest-|x| lanes survive.  Ties go to the lower
lane: lane i survives iff

    #{ |x_j| > |x_i| }  +  #{ j < i : |x_j| == |x_i| }  <  keep,

a strict total order, so exactly ``keep`` lanes survive per full block.  A
hidden size that the block does not divide (bitnet-1.3b's d_ff = 5460)
sparsifies the divisible prefix and keeps the tail lanes dense.

``das_compact`` takes its indices from that same rank mask rather than from
``torch.topk``, whose order among ties is unspecified; the JAX package's
``top_k`` + sort keeps the lower lane, which the rank rule reproduces.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["DEFAULT_BLOCK", "CompactActivation", "das_mask", "das_apply",
           "das_compact"]

DEFAULT_BLOCK = 32


class CompactActivation(NamedTuple):
    """Block-compacted activation: values + absolute K-lane indices, block b's
    survivors at positions [b*keep, (b+1)*keep) in ascending lane order."""

    values: torch.Tensor    # (..., K*keep/block)
    indices: torch.Tensor   # (..., K*keep/block) int32
    keep_per_block: int
    block_size: int


def _rank_mask(x: torch.Tensor, block_size: int, keep: int) -> torch.Tensor:
    """Rank-compare mask over a block-divisible last axis."""
    k = x.shape[-1]
    nb = k // block_size
    a = x.abs().reshape(x.shape[:-1] + (nb, block_size))
    ai = a.unsqueeze(-1)                 # lane i
    aj = a.unsqueeze(-2)                 # lane j
    gt = (aj > ai).sum(-1)
    lane = torch.arange(block_size, device=x.device)
    jlt = lane[None, :] < lane[:, None]
    eq_before = ((aj == ai) & jlt).sum(-1)
    return ((gt + eq_before) < keep).reshape(x.shape)


def das_mask(x: torch.Tensor, *, block_size: int = DEFAULT_BLOCK,
             keep: int = DEFAULT_BLOCK // 2) -> torch.Tensor:
    """Top-``keep``-per-block bool mask over |x| along the last axis."""
    k = x.shape[-1]
    if not (0 < keep <= block_size):
        raise ValueError(f"keep={keep} out of range for block {block_size}")
    rem = k % block_size
    if rem:
        main = _rank_mask(x[..., :k - rem], block_size, keep)
        tail = torch.ones(x.shape[:-1] + (rem,), dtype=torch.bool,
                          device=x.device)
        return torch.cat([main, tail], dim=-1)
    return _rank_mask(x, block_size, keep)


def das_apply(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked activations (dropped lanes zeroed).  Under autograd the
    gradient flows through the surviving lanes only: the mask (bool or int8
    0/1) is a constant, as in the paper's sparsify-then-quantize QAT."""
    return x * mask.to(x.dtype)


def das_compact(x: torch.Tensor, *, block_size: int = DEFAULT_BLOCK,
                keep: int = DEFAULT_BLOCK // 2) -> CompactActivation:
    """Compact the surviving lanes of every block (the butterfly output)."""
    k = x.shape[-1]
    if k % block_size:
        raise ValueError(f"hidden dim {k} not divisible by DAS block "
                         f"{block_size}")
    if not (0 < keep <= block_size):
        raise ValueError(f"keep={keep} out of range for block {block_size}")
    nb = k // block_size
    mask = _rank_mask(x, block_size, keep)
    mb = mask.reshape(x.shape[:-1] + (nb, block_size))
    lane = torch.arange(block_size, device=x.device)
    # survivors sort first (key 0), each group in ascending lane order
    key = torch.where(mb, lane, lane + block_size)
    idx = torch.argsort(key, dim=-1)[..., :keep]
    xb = x.reshape(x.shape[:-1] + (nb, block_size))
    vals = torch.gather(xb, -1, idx)
    base = (torch.arange(nb, device=x.device) * block_size)[:, None]
    shape = x.shape[:-1] + (nb * keep,)
    return CompactActivation(values=vals.reshape(shape),
                             indices=(idx + base).to(torch.int32).reshape(shape),
                             keep_per_block=keep, block_size=block_size)
