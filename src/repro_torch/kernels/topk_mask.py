"""CUDA launch of ``das_topk`` (kernels/csrc/topk_mask.cu).

Replaces the JAX package's ``kernels/topk_mask.py::topk_mask`` (Pallas
``_topk_mask_kernel``) and the model's ``das_compact`` / ``das_mask`` steps,
and with a norm scale also the ``rmsnorm`` before them: one block of
threads a row, 8 lanes a thread, ranked by integer compares among the 4
threads of a 32-lane block; it writes the compaction (values,
absolute lanes) when 32 divides K, else the masked dense activations, and on
request the int8 mask, the normed rows and the masked dense rows beside the
compaction (the MoE's input).  Bounded on the H100 by bytes.
"""

from __future__ import annotations

import torch

from . import build
from .ref import DasTopK

__all__ = ["das_topk_cuda"]


def das_topk_cuda(x: torch.Tensor, *, keep: int, block: int,
                  norm_scale: torch.Tensor | None = None, eps: float = 1e-6,
                  with_mask: bool = True, with_normed: bool = False,
                  with_dense: bool = False, with_compact: bool = True) -> DasTopK:
    """x (M, K) -> DasTopK of x, or of rmsnorm(norm_scale, x, eps) when a
    scale (K,) is given: compaction when 32 divides K, else masked dense;
    ``with_dense`` writes the masked dense rows beside the compaction;
    ``with_compact=False`` writes neither (every output pointer of the
    kernel may be null)."""
    if block != 32:
        raise ValueError(f"the das_topk kernel ranks 32-lane blocks; got block={block}")
    if not 0 < keep <= block:
        raise ValueError(f"keep={keep} out of range for block {block}")
    if x.ndim != 2 or x.shape[0] < 1 or x.shape[1] < 1 or not x.is_contiguous():
        raise ValueError(f"want a contiguous non-empty x (M, K); got "
                         f"{tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"das_topk takes float32/bfloat16 x, got {x.dtype}")
    m, k = x.shape
    if norm_scale is not None:
        if (norm_scale.shape != (k,) or norm_scale.dtype != x.dtype
                or norm_scale.device != x.device):
            raise ValueError(f"want a norm scale ({k},) {x.dtype} on {x.device}; got "
                             f"{tuple(norm_scale.shape)} {norm_scale.dtype} on "
                             f"{norm_scale.device}")
        norm_scale = build.aligned(norm_scale.contiguous())
    elif with_normed:
        raise ValueError("normed rows need a norm scale")
    x = build.aligned(x)
    new = lambda shape, dt: torch.empty(shape, dtype=dt, device=x.device)  # noqa: E731
    mask = new((m, k), torch.int8) if with_mask else None
    normed = new((m, k), x.dtype) if with_normed else None
    values = indices = dense = None
    if with_compact and k % block == 0:
        kc = k // block * keep
        values, indices = new((m, kc), x.dtype), new((m, kc), torch.int32)
    if with_compact and (k % block or with_dense):
        dense = new((m, k), x.dtype)
    if not (with_mask or with_normed or values is not None or dense is not None):
        raise ValueError("das_topk asked to write nothing")
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = build.library().tenet_das_topk(
        x.data_ptr(), build.dtype_code(x), m, k, keep, ptr(norm_scale), eps, ptr(mask),
        ptr(values), ptr(indices), ptr(dense), ptr(normed), build.stream_of(x))
    build.check_launch(err, "das_topk")
    return DasTopK(mask, values, indices, dense, normed)
