"""Native ternary decode-GEMMs: the counterpart of the JAX package's
``kernels/xla_gemm.py``, the second implementation of the packed GEMMs.

The JAX package runs these where its Pallas kernels do not compile, and its
autotuner (kernels/autotune.py) ranks them against the tiled kernels per
shape.  Here they are the tuned mode's alternative to the hand-written CUDA
kernels: the same datapath (weights stay base-3 packed in memory; decode,
then a product) expressed in PyTorch operators, with the products left to
``torch.matmul`` as the JAX package leaves them to XLA.  Their float32
products run with TF32 off (``models.layers.full_f32``), as the JAX package
computes them.  On the card the unpack of ``plain_matmul`` and
``gather_matmul`` is the hand-written ``twd_decode`` kernel (kernels/ops.py);
the DAS mask of ``masked_dense`` is the ``das_topk`` kernel.

The strided 5-way split (``f32dec_matmul``): byte column g packs k-lanes
5g..5g+4, digit j of every byte belongs to x column j::5, so

    for j in 0..4:  q = floor(p/3);  d_j = p - 3q - 1;  p = q
                    acc += x[:, j::5] @ d_j

peels one trit plane per iteration with float arithmetic (exact for values
< 243) and never materializes the interleaved (K, N) weight matrix.

Impl names (kernels/autotune.py) and the JAX package's:

    native_f32dec        xla_f32dec         f32dec_matmul on dense rows
    native_plain         xla_plain          plain_matmul on dense rows
    native_dense_f32dec  xla_dense_f32dec   the same on DAS-masked dense rows
    native_dense_plain   xla_dense_plain
    native_gather        xla_gather         gather_matmul on the compaction
"""

from __future__ import annotations

import torch

from repro_torch.core import twd
from repro_torch.kernels import ops
from repro_torch.models.layers import full_f32

__all__ = [
    "f32dec_matmul", "plain_matmul", "decode_matmul", "gather_matmul",
    "scatter_dense", "masked_dense", "NATIVE_GEMM_IMPLS",
]

TRITS_PER_BYTE = twd.TRITS_PER_BYTE

# dense decode-GEMM implementations selectable by the autotuner; the
# "native_dense_*" aliases are the same GEMMs fed DAS-masked dense rows
NATIVE_GEMM_IMPLS = ("native_f32dec", "native_plain", "native_dense_f32dec",
                     "native_dense_plain")

# bytes of float32 gathered weight rows that gather_matmul holds at once
_GATHER_BYTES = 1 << 28


def _epilogue(y: torch.Tensor, w_scale, x_scale) -> torch.Tensor:
    y = y * torch.as_tensor(w_scale, dtype=torch.float32, device=y.device)
    if x_scale is not None:
        y = y * x_scale.reshape(-1, 1).float()
    return y


def f32dec_matmul(x: torch.Tensor, packed: torch.Tensor, w_scale,
                  x_scale: torch.Tensor | None = None) -> torch.Tensor:
    """(M, K) @ dequant(packed[:K/5]) via the strided 5-way split -> (M, N)
    float32.  Requires K % 5 == 0; export row padding beyond K/5 is sliced
    off."""
    m, k = x.shape
    if k % TRITS_PER_BYTE:
        raise ValueError(f"f32dec_matmul needs K % 5 == 0, got K={k}")
    pf = packed[: k // TRITS_PER_BYTE].float()
    xf = x.float()
    acc = None
    with full_f32():
        for j in range(TRITS_PER_BYTE):
            q = torch.floor(pf / 3.0)
            dj = pf - 3.0 * q - 1.0          # trit plane j in {-1, 0, +1}
            pf = q
            t = xf[:, j::TRITS_PER_BYTE] @ dj
            acc = t if acc is None else acc + t
    return _epilogue(acc, w_scale, x_scale)


def plain_matmul(x: torch.Tensor, packed: torch.Tensor, w_scale,
                 x_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Decode-then-matmul (any K, incl. K % 5 != 0) -> (M, N) float32; the
    decode is ``ops.twd_decode``."""
    m, k = x.shape
    w = ops.twd_decode(packed, k).float()
    with full_f32():
        y = x.float() @ w
    return _epilogue(y, w_scale, x_scale)


def decode_matmul(x: torch.Tensor, packed: torch.Tensor, w_scale, *, impl: str,
                  x_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Dispatch one of NATIVE_GEMM_IMPLS on dense (already masked) rows."""
    if impl.endswith("f32dec"):
        return f32dec_matmul(x, packed, w_scale, x_scale)
    if impl.endswith("plain"):
        return plain_matmul(x, packed, w_scale, x_scale)
    raise ValueError(f"decode_matmul: unknown impl {impl!r}")


def gather_matmul(values: torch.Tensor, indices: torch.Tensor, packed: torch.Tensor,
                  w_scale) -> torch.Tensor:
    """Compacted (M, Kc) values at absolute lanes ``indices`` x packed (R,
    N) -> (M, N) float32: decode every lane (``ops.twd_decode``), gather each
    row's kept weight rows, and contract (the JAX package's gather oracle,
    in slices of rows that hold at most 256 MiB of gathered rows)."""
    m, kc = values.shape
    n = packed.shape[1]
    w = ops.twd_decode(packed, packed.shape[0] * TRITS_PER_BYTE).float()
    step = max(1, _GATHER_BYTES // max(1, kc * n * 4))
    vals, idx = values.float(), indices.long()
    with full_f32():
        y = torch.cat([torch.einsum("mk,mkn->mn", vals[i:i + step], w[idx[i:i + step]])
                       for i in range(0, m, step)])
    return _epilogue(y, w_scale, None)


def scatter_dense(values: torch.Tensor, indices: torch.Tensor, k: int, *,
                  keep: int, block: int) -> torch.Tensor:
    """Compacted (M, Kc) values at absolute lanes -> dense-masked (M, K)
    float32; exactly x * das_mask(x) for a das_compact output (``keep`` of
    every ``block`` lanes, Kc == K / block * keep)."""
    m, kc = values.shape
    if k % block or kc != k // block * keep:
        raise ValueError(f"Kc={kc} is not K / block * keep for K={k}, "
                         f"block={block}, keep={keep}")
    dense = torch.zeros((m, k), dtype=torch.float32, device=values.device)
    return dense.scatter_(1, indices.long(), values.float())


def masked_dense(x: torch.Tensor, *, keep: int, block: int) -> torch.Tensor:
    """Dense DAS-masked activations (..., K) -> (M, K) float32 over the
    flattened rows: the ``das_topk`` step's masked dense rows (a block that
    does not divide K keeps a dense tail, bitnet-1.3b's d_ff = 5460)."""
    step = ops.das_topk(x, keep=keep, block=block, with_mask=False, with_dense=True)
    return step.dense.float()
