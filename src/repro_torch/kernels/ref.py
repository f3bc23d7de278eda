"""Plain PyTorch versions of the six CUDA kernels on the serving paths.

Each function computes what its kernel computes, on any device, with
PyTorch operators: the kernel wrappers (kernels/ops.py) take these for CPU
tensors, the CPU tests hold them against the JAX package's oracles, and
chip_smoke.py holds each kernel against its plain version on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import das as das_lib
from repro_torch.core import twd
from repro_torch.core.lpsa import lpsa_allowed
from repro_torch.models.layers import rmsnorm

__all__ = ["DasTopK", "das_topk_ref", "ternary_gemm_ref",
           "das_ternary_gemm_ref", "sparse_attention_ref", "twd_decode_ref",
           "twd_decode_stack_ref", "das_gemv_ref", "score_scale", "NEG_INF"]

NEG_INF = -1e30


class DasTopK(NamedTuple):
    """What the DAS step hands the projections: the compaction (values,
    indices) when the block divides K, or the masked dense activations (tail
    lanes kept) when it does not; on request the int8 mask (M, K), after a
    norm the normed rows (M, K) it ranked, and the masked dense rows beside
    the compaction."""
    mask: torch.Tensor | None
    values: torch.Tensor | None
    indices: torch.Tensor | None
    dense: torch.Tensor | None
    normed: torch.Tensor | None = None


def das_topk_ref(x: torch.Tensor, *, keep: int, block: int,
                 norm_scale: torch.Tensor | None = None, eps: float = 1e-6,
                 with_mask: bool = True, with_normed: bool = False,
                 with_dense: bool = False, with_compact: bool = True) -> DasTopK:
    """x (M, K) -> DasTopK, the semantics of core.das on one flat batch; with
    ``norm_scale``, of ``rmsnorm(norm_scale, x, eps)`` (models/layers.py);
    ``with_dense`` gives the masked dense rows beside the compaction;
    ``with_compact=False`` neither (the mask and normed rows alone)."""
    normed = None
    if norm_scale is not None:
        x = normed = rmsnorm(norm_scale, x, eps)
    mask = das_lib.das_mask(x, block_size=block, keep=keep)
    values = indices = dense = None
    if with_compact and x.shape[-1] % block == 0:
        ca = das_lib.das_compact(x, block_size=block, keep=keep)
        values, indices = ca.values, ca.indices
    if with_compact and (x.shape[-1] % block or with_dense):
        dense = das_lib.das_apply(x, mask)
    return DasTopK(mask.to(torch.int8) if with_mask else None, values, indices, dense,
                   normed if with_normed else None)


def _decoded(packed: torch.Tensor) -> torch.Tensor:
    """All 5R lanes of the packed slab as float32 (padding lanes are 0)."""
    return twd.unpack_ternary_arith(packed, packed.shape[0] * 5).float()


def ternary_gemm_ref(x: torch.Tensor, packed: torch.Tensor,
                     w_scale: torch.Tensor | float,
                     x_scale: torch.Tensor | None = None) -> torch.Tensor:
    """(M, K) x packed (R, N), 5R >= K -> (M, N) float32.

    int8 activations: every partial sum is an integer below 2**24, so the
    float32 product is exact, as the kernel's int32 accumulation is."""
    k = x.shape[-1]
    w = _decoded(packed)[:k]
    out = (x.float() @ w) * w_scale
    if x_scale is not None:
        out = out * x_scale.reshape(-1, 1)
    return out


def das_ternary_gemm_ref(values: torch.Tensor, indices: torch.Tensor,
                         packed: torch.Tensor,
                         w_scale: torch.Tensor | float) -> torch.Tensor:
    """(M, Kc) compacted values at absolute lanes `indices` x packed (R, N)
    -> (M, N) float32: the values scattered to their dense lanes, times the
    decoded weights (the JAX oracle gathers weight rows instead — the same
    sum over the kept lanes)."""
    w = _decoded(packed)
    dense = torch.zeros((values.shape[0], w.shape[0]), dtype=torch.float32,
                        device=values.device)
    dense.scatter_(1, indices.long(), values.float())
    return (dense @ w) * w_scale


def twd_decode_ref(packed: torch.Tensor, k: int) -> torch.Tensor:
    """uint8 base-3 packed (R, N) -> int8 trits (k, N), k <= 5R (the JAX
    oracle's LUT gather)."""
    return twd.unpack_ternary(packed, k)


def twd_decode_stack_ref(packed: torch.Tensor, k: int) -> torch.Tensor:
    """A stack of base-3 packed weights (E, R, N) uint8 -> int8 trits (E, k,
    N), k <= 5R: each expert's (R, N) slab decoded alone (the JAX package
    unpacks the stack expert by expert)."""
    trits = twd.unpack_ternary(packed.movedim(0, 1), k)     # (k, E, N)
    return trits.movedim(1, 0).contiguous()


def das_gemv_ref(values: torch.Tensor, indices: torch.Tensor | None,
                 trits: torch.Tensor, w_scale: torch.Tensor | float) -> torch.Tensor:
    """(M, Kc) values at distinct absolute lanes ``indices`` x int8 trits
    (K, N) -> (M, N) float32; ``indices=None`` takes dense rows (Kc == K).

    The JAX oracle gathers the kept weight rows of one token and dots; this
    scatters each row's values to their dense lanes and multiplies with all
    K rows — the same sum over the kept lanes, without an (M, Kc, N) gather."""
    if indices is None:
        dense = values.float()
    else:
        dense = torch.zeros((values.shape[0], trits.shape[0]), dtype=torch.float32,
                            device=values.device)
        dense.scatter_(1, indices.long(), values.float())
    return (dense @ trits.float()) * w_scale


def score_scale(d: int, dtype: torch.dtype, round_scores: bool) -> float:
    """The 1/sqrt(D) score scale: in float32, or, with ``round_scores``,
    computed in the input dtype as the JAX package's reference attention
    does (``1.0 / jnp.sqrt(d).astype(q.dtype)``, core/lpsa.py)."""
    if not round_scores:
        return 1.0 / d ** 0.5
    return float(1.0 / torch.tensor(d ** 0.5, dtype=torch.float32).to(dtype))


def sparse_attention_ref(q, k, v, q_pos, k_pos, *, sink: int, window: int,
                         softcap: float | None = None,
                         round_scores: bool = False) -> torch.Tensor:
    """q (B, Lq, Hq, D); k, v (B, Lk, Hkv, D); q_pos (B, Lq); k_pos (B, Lk)
    with k_pos < 0 an empty slot.  Float32 softmax; rows with no allowed key
    give 0.  Returns (B, Lq, Hq, D) in q's dtype.

    ``round_scores`` rounds q.k to q's dtype before the scale (score_scale),
    as the JAX package's streaming prefill attends (core/lpsa.py
    ``_softmax_attend``)."""
    d = q.shape[-1]
    n_rep = q.shape[2] // k.shape[2]
    kr = k.float().repeat_interleave(n_rep, dim=2)
    vr = v.float().repeat_interleave(n_rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr)
    if round_scores:
        s = s.to(q.dtype).float()
    s = s * score_scale(d, q.dtype, round_scores)
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    mask = lpsa_allowed(q_pos[:, :, None], k_pos[:, None, :], sink, window)
    mask = (mask & (k_pos >= 0)[:, None, :])[:, None]          # (B,1,Lq,Lk)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(-1, keepdim=True), p, 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", p, vr).to(q.dtype)
