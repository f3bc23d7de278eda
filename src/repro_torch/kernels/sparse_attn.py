"""CUDA launch of ``sparse_attention`` (kernels/csrc/sparse_attn.cu).

Replaces the JAX package's ``kernels/sparse_attn.py::sparse_attention``
(Pallas ``_attn_kernel``): LPSA sink + window attention with an online
softmax in float32, GQA, optional tanh soft-cap, empty slots at position -1.
It serves the ring-cache decode (Lq = 1), the prefill packs (``[sink |
window | pack]`` keys) and full-cache serving (sink = 2**30).  The class
follows from Lq and the dtype alone: at Lq = 1 the keys of each (q head,
batch row) are split over a thread-block cluster and merged in block order
in the same launch; at Lq > 1 in bfloat16 a block takes 64 queries of one
head on the tensor cores (mma.sync) over tiles of 64 keys, skips the key
tiles that no query of it may attend, and splits the keys over a cluster
the same way; at Lq > 1 in float32 a block takes one query on FMAs.  At
Lq = 1 the decode class also takes float32 q over bfloat16 K and V (a
float32 residual stream reading its bfloat16 ring: the stub-frontend
models), converting the rows in registers and writing a float32 output,
which is the plain version's function without an upcast copy of the ring.
A query's output bits do not depend on the batch or on the other queries.
"""

from __future__ import annotations

import torch

from . import build, ref

__all__ = ["sparse_attention_cuda", "HEAD_DIMS"]

HEAD_DIMS = (16, 32, 64, 80, 100, 160, 256)   # head sizes the kernel is instantiated for


def sparse_attention_cuda(q, k, v, q_pos, k_pos, *, sink: int, window: int,
                          softcap: float | None = None,
                          round_scores: bool = False) -> torch.Tensor:
    """q (B, Lq, Hq, D); k, v (B, Lk, Hkv, D); q_pos (B, Lq), k_pos (B, Lk)
    int32 -> (B, Lq, Hq, D) in q's dtype.  q, k and v share one dtype,
    float32 or bfloat16, except at Lq = 1, where float32 q may read
    bfloat16 k and v.  ``round_scores`` rounds q.k to q's dtype before the
    scale, which is then computed in q's dtype (ref.score_scale)."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B, Lq, Hq, D) and k, v (B, Lk, Hkv, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, lq, hq, d = q.shape
    _, lk, hkv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not match k {tuple(k.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in the kernel's {HEAD_DIMS}")
    mixed = (q.dtype == torch.float32 and k.dtype == torch.bfloat16 and lq == 1)
    if q.dtype not in (torch.float32, torch.bfloat16) or v.dtype != k.dtype \
            or (k.dtype != q.dtype and not mixed):
        raise ValueError(f"sparse_attention takes float32/bfloat16 q, k, v of "
                         f"one dtype, or at Lq = 1 float32 q over bfloat16 k, v; "
                         f"got {q.dtype}, {k.dtype}, {v.dtype} at Lq = {lq}")
    if q_pos.shape != (b, lq) or k_pos.shape != (b, lk) \
            or q_pos.dtype != torch.int32 or k_pos.dtype != torch.int32:
        raise ValueError("q_pos (B, Lq) and k_pos (B, Lk) must be int32")
    for t in (q, k, v, q_pos, k_pos):
        if not t.is_contiguous():
            raise ValueError("sparse_attention needs contiguous inputs")
        if t.device != q.device:
            raise ValueError(f"tensors on {q.device} and {t.device}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k, v must be 16-byte aligned")
    if min(b, lq, lk) < 1:
        raise ValueError("sparse_attention needs non-empty B, Lq, Lk")
    out = torch.empty_like(q)
    err = build.library().tenet_sparse_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
        k_pos.data_ptr(), out.data_ptr(), build.dtype_code(q), build.dtype_code(k),
        b, lq, lk, hq, hkv, d, sink, window, 0.0 if softcap is None else float(softcap),
        ref.score_scale(d, q.dtype, round_scores), int(round_scores),
        build.stream_of(q))
    build.check_launch(err, "sparse_attention")
    return out
