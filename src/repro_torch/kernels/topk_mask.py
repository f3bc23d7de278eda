"""CUDA launch of ``das_topk`` (kernels/csrc/topk_mask.cu).

Replaces the JAX package's ``kernels/topk_mask.py::topk_mask`` (Pallas
``_topk_mask_kernel``) and the model's ``das_compact`` / ``das_mask`` steps:
one warp per 32-lane block ranks its lanes with ``__shfl_sync`` compares and
writes the int8 mask together with either the compaction (values, absolute
lanes) or the masked dense activations.  Bounded on the H100 by bytes.
"""

from __future__ import annotations

import torch

from . import build
from .ref import DasTopK

__all__ = ["das_topk_cuda"]


def das_topk_cuda(x: torch.Tensor, *, keep: int, block: int) -> DasTopK:
    """x (M, K) -> DasTopK: compaction when 32 divides K, else masked dense."""
    if block != 32:
        raise ValueError(f"the das_topk kernel ranks warp-wide 32-lane blocks; "
                         f"got block={block}")
    if not 0 < keep <= block:
        raise ValueError(f"keep={keep} out of range for block {block}")
    if x.ndim != 2 or x.shape[0] < 1 or x.shape[1] < 1 or not x.is_contiguous():
        raise ValueError(f"want a contiguous non-empty x (M, K); got "
                         f"{tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"das_topk takes float32/bfloat16 x, got {x.dtype}")
    m, k = x.shape
    mask = torch.empty((m, k), dtype=torch.int8, device=x.device)
    values = indices = dense = None
    if k % block == 0:
        kc = k // block * keep
        values = torch.empty((m, kc), dtype=x.dtype, device=x.device)
        indices = torch.empty((m, kc), dtype=torch.int32, device=x.device)
    else:
        dense = torch.empty_like(x)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = build.library().tenet_das_topk(
        x.data_ptr(), build.dtype_code(x), m, k, keep, mask.data_ptr(),
        ptr(values), ptr(indices), ptr(dense), build.stream_of(x))
    build.check_launch(err, "das_topk")
    return DasTopK(mask, values, indices, dense)
