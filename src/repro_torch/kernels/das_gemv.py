"""CUDA launch of ``das_gemv`` (kernels/csrc/das_gemv.cu).

Replaces the JAX package's ``kernels/das_gemm.py::das_gemv`` (Pallas
``_das_gemv_kernel``): DAS-compacted activations against unpacked int8
trits, the int8-resident serving format.  Unlike the TPU kernel it takes a
batch of rows, any K, and dense rows (``indices=None``) for the projections
whose K the DAS block does not divide and for DAS off.  Bounded on the H100
by the trit bytes at decode; see the source for the design.
"""

from __future__ import annotations

import torch

from . import build

__all__ = ["das_gemv_cuda"]


def das_gemv_cuda(values: torch.Tensor, indices: torch.Tensor | None,
                  trits: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """values (M, Kc) at lanes ``indices`` (M, Kc) int32, or dense rows
    (``indices=None``, Kc == K), x trits (K, N) int8 -> (M, N) float32.

    ``indices`` are distinct absolute lanes in [0, K), ascending per row
    (core.das.das_compact or the das_topk kernel)."""
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
    if m < 1 or kc < 1 or n < 1 or kc > k or (indices is None and kc != k):
        raise ValueError(f"das_gemv needs M, Kc, N >= 1, Kc <= K and Kc == K for "
                         f"dense rows; got M={m}, Kc={kc}, K={k}, N={n}")
    if not build.gemv_lanes_fit(k):
        raise ValueError(f"K={k}: the staged activations exceed shared memory")
    if not (values.is_contiguous() and trits.is_contiguous()
            and (indices is None or indices.is_contiguous())):
        raise ValueError("das_gemv needs contiguous inputs")
    if w_scale.dtype != torch.float32 or w_scale.numel() != 1:
        raise ValueError("w_scale must be one float32 value")
    for t in (trits, w_scale) + (() if indices is None else (indices,)):
        if t.device != values.device:
            raise ValueError(f"tensors on {values.device} and {t.device}")
    out = torch.empty((m, n), dtype=torch.float32, device=values.device)
    err = build.library().tenet_das_gemv(
        values.data_ptr(), build.dtype_code(values),
        None if indices is None else indices.data_ptr(), trits.data_ptr(),
        w_scale.data_ptr(), out.data_ptr(), m, kc, k, n, build.stream_of(values))
    build.check_launch(err, "das_gemv")
    return out
