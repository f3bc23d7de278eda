"""CUDA launch of ``twd_decode`` (kernels/csrc/twd_decode.cu).

Replaces the JAX package's ``kernels/ternary_gemm.py::twd_decode`` (Pallas
``_twd_decode_kernel``): the TWD decompressor, base-3 packed bytes to int8
trits, five a byte, through a 256-entry table in shared memory with
vector loads and stores.  It loads a packed model's weights into the
int8-resident serving form (``models.model.trits_from_packed``).  Bounded
on the H100 by the bytes it reads and writes; see the source.
"""

from __future__ import annotations

import torch

from . import build

__all__ = ["twd_decode_cuda"]


def twd_decode_cuda(packed: torch.Tensor, k: int) -> torch.Tensor:
    """packed (R, N) uint8 -> trits (k, N) int8, k <= 5R."""
    if packed.ndim != 2 or packed.dtype != torch.uint8:
        raise ValueError(f"want packed (R, N) uint8; got {tuple(packed.shape)} "
                         f"{packed.dtype}")
    r, n = packed.shape
    if r < 1 or n < 1 or not 1 <= k <= 5 * r:
        raise ValueError(f"twd_decode needs R, N >= 1 and 1 <= k <= 5R; got R={r}, "
                         f"N={n}, k={k}")
    if not packed.is_contiguous():
        raise ValueError("twd_decode needs contiguous packed weights")
    packed = build.aligned(packed)
    out = torch.empty((k, n), dtype=torch.int8, device=packed.device)
    err = build.library().tenet_twd_decode(packed.data_ptr(), out.data_ptr(), r, k, n,
                                           build.stream_of(packed))
    build.check_launch(err, "twd_decode")
    return out
