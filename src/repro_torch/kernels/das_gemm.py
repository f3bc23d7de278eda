"""CUDA launch of ``das_ternary_gemm`` (kernels/csrc/das_gemm.cu).

Replaces the JAX package's ``kernels/das_gemm.py::das_ternary_gemm``
(Pallas ``_das_ternary_gemm_kernel``).  Each block scatters the compacted
entries of its K window to their dense lanes in shared memory, against
base-3 packed weights decoded in registers.  Unlike the TPU kernel it takes
the padded export (5R >= K), so every bitnet-1.3b projection with a
block-divisible K runs on it.  Bounded on the H100 by the packed weight
bytes at decode and by the bf16 tensor-core rate at prefill; see
csrc/common.cuh for the design.
"""

from __future__ import annotations

import torch

from . import build

__all__ = ["das_ternary_gemm_cuda", "compacted_lanes"]


def compacted_lanes(kc: int, keep: int, block: int, rows: int) -> int:
    """K of (M, Kc) entries that das_compact made with ``keep`` of every
    ``block`` lanes (Kc = K / block * keep); raises where the kernel cannot
    take them: a block that does not divide a window's 160 lanes, a Kc that
    is not whole blocks, or more lanes than the ``rows`` packed rows hold."""
    if not 1 <= keep <= block or build.WIN_LANES % block:
        raise ValueError(f"das_ternary_gemm takes 1 <= keep <= block with block "
                         f"dividing {build.WIN_LANES}; got keep={keep}, block={block}")
    if kc < 1 or kc % keep or kc // keep * block > 5 * rows:
        raise ValueError(f"Kc={kc} is not K / block * keep for a K of whole "
                         f"{block}-lane blocks within the {5 * rows} packed lanes "
                         f"(keep={keep})")
    return kc // keep * block


def das_ternary_gemm_cuda(values: torch.Tensor, indices: torch.Tensor,
                          packed: torch.Tensor, w_scale: torch.Tensor, *,
                          keep: int, block: int = 32,
                          config: build.LaunchConfig = build.DEFAULT_CONFIG) -> torch.Tensor:
    """values/indices (M, Kc) x packed (R, N) uint8 -> (M, N) float32.

    ``indices`` are absolute lanes as das_compact lays them out (core.das or
    the das_topk kernel): ``keep`` ascending lanes of every ``block``, so
    Kc == K / block * keep (checked).  ``config`` is the launch config
    (build.LaunchConfig; checked, never replaced)."""
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
    if m < 1 or n < 1:
        raise ValueError(f"das_ternary_gemm needs M, N >= 1; got M={m}, N={n}")
    compacted_lanes(kc, keep, block, r)
    if not build.packed_rows_fit(m, r):
        raise ValueError(f"packed rows {r}: the decode class (M <= 4) takes at most "
                         f"{build.DECODE_MAX_ROWS}")
    build.check_launch_config(m, r, n, build.das_mma_route(values.dtype, kc, keep, block, n),
                              config)
    if not (values.is_contiguous() and indices.is_contiguous()
            and packed.is_contiguous()):
        raise ValueError("das_ternary_gemm needs contiguous inputs")
    if w_scale.dtype != torch.float32 or w_scale.numel() != 1:
        raise ValueError("w_scale must be one float32 value")
    for t in (indices, packed, w_scale):
        if t.device != values.device:
            raise ValueError(f"tensors on {values.device} and {t.device}")
    values, indices = build.aligned(values), build.aligned(indices)
    packed = build.aligned(packed)
    out = torch.empty((m, n), dtype=torch.float32, device=values.device)
    err = build.library().tenet_das_ternary_gemm(
        values.data_ptr(), build.dtype_code(values), indices.data_ptr(),
        packed.data_ptr(), w_scale.data_ptr(), out.data_ptr(), m, kc, keep,
        block, r, n, config.subs, config.parts, build.stream_of(values))
    build.check_launch(err, "das_ternary_gemm")
    return out
