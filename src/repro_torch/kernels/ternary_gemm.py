"""CUDA launch of ``ternary_gemm`` (kernels/csrc/ternary_gemm.cu).

Replaces the JAX package's ``kernels/ternary_gemm.py::ternary_gemm``
(Pallas ``_ternary_gemm_kernel``).  Dense activations (float32, bfloat16, or
int8 with a per-row scale) times base-3 packed ternary weights, decoded in
registers.  Bounded on the H100 by the packed weight bytes at decode (split
over K windows that reduce in order through a thread-block cluster) and by
the bf16 tensor-core rate at prefill; see csrc/common.cuh for the design.
"""

from __future__ import annotations

import torch

from . import build

__all__ = ["ternary_gemm_cuda"]


def ternary_gemm_cuda(x: torch.Tensor, packed: torch.Tensor,
                      w_scale: torch.Tensor,
                      x_scale: torch.Tensor | None = None, *,
                      config: build.LaunchConfig = build.DEFAULT_CONFIG) -> torch.Tensor:
    """x (M, K) x packed (R, N) uint8 with 5R >= K -> (M, N) float32, at the
    launch config ``config`` (build.LaunchConfig; checked, never
    replaced)."""
    if x.ndim != 2 or packed.ndim != 2:
        raise ValueError(f"want x (M, K) and packed (R, N); got {tuple(x.shape)}"
                         f" and {tuple(packed.shape)}")
    m, k = x.shape
    r, n = packed.shape
    if x.dtype not in (torch.float32, torch.bfloat16, torch.int8):
        raise ValueError(f"ternary_gemm takes float32/bfloat16/int8 x, got {x.dtype}")
    if packed.dtype != torch.uint8:
        raise ValueError(f"packed weights must be uint8, got {packed.dtype}")
    if 5 * r < k:
        raise ValueError(f"packed rows {r} hold {5 * r} trits < K={k}")
    if m < 1 or n < 1 or k < 1:
        raise ValueError(f"ternary_gemm needs M, K, N >= 1; got M={m}, K={k}, N={n}")
    if x.dtype == torch.int8 and k > 100_000:
        raise ValueError("int32 accumulation is no longer exact at this K")
    if not build.packed_rows_fit(m, r):
        raise ValueError(f"packed rows {r}: the decode class (M <= 4) takes at most "
                         f"{build.DECODE_MAX_ROWS}")
    build.check_launch_config(m, r, n, build.dense_mma_route(x.dtype, k, n), config)
    if not (x.is_contiguous() and packed.is_contiguous()):
        raise ValueError("ternary_gemm needs contiguous x and packed")
    if w_scale.dtype != torch.float32 or w_scale.numel() != 1:
        raise ValueError("w_scale must be one float32 value")
    if x_scale is not None and (x_scale.dtype != torch.float32
                                or x_scale.numel() != m
                                or not x_scale.is_contiguous()):
        raise ValueError("x_scale must be M contiguous float32 values")
    for t in (packed, w_scale) + (() if x_scale is None else (x_scale,)):
        if t.device != x.device:
            raise ValueError(f"tensors on {x.device} and {t.device}")
    x, packed = build.aligned(x), build.aligned(packed)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    err = build.library().tenet_ternary_gemm(
        x.data_ptr(), build.dtype_code(x), packed.data_ptr(),
        w_scale.data_ptr(), None if x_scale is None else x_scale.data_ptr(),
        out.data_ptr(), m, k, r, n, config.subs, config.parts, build.stream_of(x))
    build.check_launch(err, "ternary_gemm")
    return out
