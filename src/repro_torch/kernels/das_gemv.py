"""CUDA launch of ``das_gemv`` (kernels/csrc/das_gemv.cu).

Replaces the JAX package's ``kernels/das_gemm.py::das_gemv`` (Pallas
``_das_gemv_kernel``): DAS-compacted activations against unpacked int8
trits, the int8-resident serving format.  Unlike the TPU kernel it takes a
batch of rows, any K, and dense rows (``indices=None``) for the projections
whose K the DAS block does not divide and for DAS off.  It runs on the GEMM
core of csrc/common.cuh with int8 trit rows as the weight source; bounded
on the H100 by the trit bytes at decode and by the bf16 tensor-core rate at
prefill.
"""

from __future__ import annotations

import torch

from . import build

__all__ = ["das_gemv_cuda", "gemv_compaction"]


def gemv_compaction(kc: int, k: int, keep: int, block: int) -> None:
    """Raise unless (M, Kc) entries are das_compact's of K lanes, ``keep`` of
    every ``block``: Kc == K / block * keep, as the JAX op checks
    (``Kc * BLOCK == K * keep``), with a block that divides a window's 160
    lanes."""
    if not 1 <= keep <= block or build.WIN_LANES % block:
        raise ValueError(f"das_gemv takes 1 <= keep <= block with block dividing "
                         f"{build.WIN_LANES}; got keep={keep}, block={block}")
    if k % block or kc != k // block * keep:
        raise ValueError(f"Kc={kc} inconsistent with K={k}, keep={keep}, block={block}")


def das_gemv_cuda(values: torch.Tensor, indices: torch.Tensor | None,
                  trits: torch.Tensor, w_scale: torch.Tensor, *, keep: int = 16,
                  block: int = 32) -> torch.Tensor:
    """values (M, Kc) at lanes ``indices`` (M, Kc) int32, or dense rows
    (``indices=None``, Kc == K), x trits (K, N) int8 -> (M, N) float32.

    ``indices`` are absolute lanes as das_compact lays them out (core.das or
    the das_topk kernel): ``keep`` ascending lanes of every ``block``, so
    Kc == K / block * keep (checked)."""
    if values.ndim != 2 or trits.ndim != 2 or (
            indices is not None and indices.shape != values.shape):
        raise ValueError(f"want values/indices (M, Kc) and trits (K, N); got "
                         f"{tuple(values.shape)}, "
                         f"{None if indices is None else tuple(indices.shape)}, "
                         f"{tuple(trits.shape)}")
    m, kc = values.shape
    k, n = trits.shape
    if values.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"das_gemv takes float32/bfloat16 values, got {values.dtype}")
    if trits.dtype != torch.int8 or (indices is not None
                                     and indices.dtype != torch.int32):
        raise ValueError("trits must be int8 and indices int32")
    if m < 1 or k < 1 or n < 1 or (indices is None and kc != k):
        raise ValueError(f"das_gemv needs M, K, N >= 1 and Kc == K for dense rows; "
                         f"got M={m}, Kc={kc}, K={k}, N={n}")
    if indices is not None:
        gemv_compaction(kc, k, keep, block)
    if not build.packed_rows_fit(m, -(-k // 5)):
        raise ValueError(f"K={k}: the decode class (M <= 4) takes at most "
                         f"{5 * build.DECODE_MAX_ROWS} lanes")
    if not (values.is_contiguous() and trits.is_contiguous()
            and (indices is None or indices.is_contiguous())):
        raise ValueError("das_gemv needs contiguous inputs")
    if w_scale.dtype != torch.float32 or w_scale.numel() != 1:
        raise ValueError("w_scale must be one float32 value")
    for t in (trits, w_scale) + (() if indices is None else (indices,)):
        if t.device != values.device:
            raise ValueError(f"tensors on {values.device} and {t.device}")
    values, trits = build.aligned(values), build.aligned(trits)
    if indices is not None:
        indices = build.aligned(indices)
    out = torch.empty((m, n), dtype=torch.float32, device=values.device)
    err = build.library().tenet_das_gemv(
        values.data_ptr(), build.dtype_code(values),
        None if indices is None else indices.data_ptr(), trits.data_ptr(),
        w_scale.data_ptr(), out.data_ptr(), m, kc, keep, block, k, n,
        build.stream_of(values))
    build.check_launch(err, "das_gemv")
    return out
