"""CUDA launch of ``das_ternary_gemm`` (kernels/csrc/das_gemm.cu).

Replaces the JAX package's ``kernels/das_gemm.py::das_ternary_gemm``
(Pallas ``_das_ternary_gemm_kernel``).  DAS-compacted activations are
scattered to their dense lanes in shared memory, once per block, against
base-3 packed weights decoded in registers.  Unlike the TPU
kernel it takes the padded export (5R >= K), so every bitnet-1.3b
projection with a block-divisible K runs on it.  Bounded on the H100 by the
packed weight bytes at decode; see the source for the design.
"""

from __future__ import annotations

import torch

from . import build

__all__ = ["das_ternary_gemm_cuda"]


def das_ternary_gemm_cuda(values: torch.Tensor, indices: torch.Tensor,
                          packed: torch.Tensor,
                          w_scale: torch.Tensor) -> torch.Tensor:
    """values/indices (M, Kc) x packed (R, N) uint8 -> (M, N) float32.

    ``indices`` are absolute lanes in [0, 5R) (core.das.das_compact or the
    das_topk kernel)."""
    if values.ndim != 2 or values.shape != indices.shape or packed.ndim != 2:
        raise ValueError(f"want values/indices (M, Kc) and packed (R, N); got "
                         f"{tuple(values.shape)}, {tuple(indices.shape)}, "
                         f"{tuple(packed.shape)}")
    m, kc = values.shape
    r, n = packed.shape
    if values.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"das_ternary_gemm takes float32/bfloat16 values, got "
                         f"{values.dtype}")
    if indices.dtype != torch.int32 or packed.dtype != torch.uint8:
        raise ValueError("indices must be int32 and packed weights uint8")
    if m < 1 or kc < 1 or kc > 5 * r or n % 2 or packed.data_ptr() % 2:
        raise ValueError(f"das_ternary_gemm needs M, Kc >= 1, Kc <= 5R, even N "
                         f"and an even packed address; got M={m}, Kc={kc}, "
                         f"R={r}, N={n}")
    if not build.staged_rows_fit(r):
        raise ValueError(f"packed rows {r}: the staged activations exceed shared memory")
    if not (values.is_contiguous() and indices.is_contiguous()
            and packed.is_contiguous()):
        raise ValueError("das_ternary_gemm needs contiguous inputs")
    if w_scale.dtype != torch.float32 or w_scale.numel() != 1:
        raise ValueError("w_scale must be one float32 value")
    for t in (indices, packed, w_scale):
        if t.device != values.device:
            raise ValueError(f"tensors on {values.device} and {t.device}")
    out = torch.empty((m, n), dtype=torch.float32, device=values.device)
    err = build.library().tenet_das_ternary_gemm(
        values.data_ptr(), build.dtype_code(values), indices.data_ptr(),
        packed.data_ptr(), w_scale.data_ptr(), out.data_ptr(), m, kc, r, n,
        build.stream_of(values))
    build.check_launch(err, "das_ternary_gemm")
    return out
