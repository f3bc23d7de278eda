"""Chunked gated linear attention, the engine of GLA and RWKV6.

Recurrence (per head, per key-dim gated decay alpha_t in (0, 1]):

    S_t = diag(alpha_t) S_{t-1} + k_t^T v_t
    GLA  : o_t = q_t S_t
    RWKV6: o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)      (bonus on self)

Chunked parallel form: within a chunk, with La = cumsum(log alpha) (per key
dim),

    o_t = (q_t * e^{La_t - d_t}) @ S_in                          (inter)
        + sum_{s < t} [(q_t * e^{La_t - d_t}) . (k_s * e^{-La_s})] v_s  (intra)
    S_out = diag(e^{La_L}) S_in + sum_s (k_s * e^{La_L - La_s})^T v_s

where d_t = log alpha_t for RWKV and 0 for GLA, and "s < t" is s <= t for
GLA (RWKV's self term is the u bonus).  The JAX package computes this with
a ``lax.scan`` of einsums outside any Pallas kernel; here the scan is a
loop over chunks, the same einsums in float32 with TF32 off on the card
(``layers.full_f32``).  ``chunk_size`` is the JAX package's chunk rule, so
both sum over the same chunks.  The prefill and the training pass run the
same function; under autograd every chunk's tensors are new (nothing saved
is written in place), and the decay floor is ``torch.maximum``, whose
gradient splits at a tie as ``jnp.maximum``'s does (``torch.clamp`` passes
it whole).  ``linear_attn_step`` is the exact one-token
recurrence; it returns the new state for the caller to write in place.
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import full_f32

__all__ = ["LOG_A_MIN", "CHUNK", "chunk_size", "chunked_linear_attn", "linear_attn_step"]

# per-step log-decay floor: keeps the factorised chunk form exact in float32
# (|cumsum| <= chunk * |LOG_A_MIN| => exp(-cumsum) < float32 max)
LOG_A_MIN = -1.5
CHUNK = 64    # the chunk both blocks ask for, as the JAX package's do (then the rule)


def chunk_size(l: int, chunk: int) -> int:
    """The chunk a length-l sequence is cut into: min(chunk, l), and when
    that times |LOG_A_MIN| passes 85, the largest divisor of l at most 56
    (1 for a prime l above 56)."""
    c = min(chunk, l)
    if c * -LOG_A_MIN > 85.0:
        c = max(1, int(85.0 // -LOG_A_MIN))
        while l % c:
            c -= 1
    if l % c:
        raise ValueError(f"L={l} not divisible by chunk={c}")
    return c


def chunked_linear_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        log_a: torch.Tensor, *, chunk: int, mode: str = "gla",
                        u: torch.Tensor | None = None, s0: torch.Tensor | None = None):
    """q, k, v, log_a (B, L, H, D) (log_a per key dim, <= 0); u (H, D) the
    RWKV bonus; s0 (B, H, D, D) float32 or None (zeros).  Returns (o (B, L,
    H, D) in q's dtype, the final state (B, H, D, D) float32)."""
    b, l, h, d = q.shape
    c = chunk_size(l, chunk)
    n = l // c

    def tohead(x):                                   # (n, B, H, c, D) float32
        return x.float().reshape(b, n, c, h, d).permute(1, 0, 3, 2, 4)

    qc, kc, vc, lac = map(tohead, (q, k, v, log_a))
    s = s0 if s0 is not None else torch.zeros((b, h, d, d), dtype=torch.float32,
                                             device=q.device)
    causal = torch.ones((c, c), dtype=torch.bool, device=q.device).tril(
        0 if mode == "gla" else -1)
    uf = u.float() if u is not None else None
    floor = torch.full((), LOG_A_MIN, device=q.device)
    outs = []
    with full_f32(), torch.profiler.record_function("chunked_linear_attn"):
        for i in range(n):
            qb, kb, vb = qc[i], kc[i], vc[i]
            la = torch.maximum(lac[i], floor)   # half the gradient at a tie, as jnp.maximum
            cla = torch.cumsum(la, dim=-2)               # inclusive (B, H, c, D)
            q_eff = qb * torch.exp(cla - la if mode == "rwkv" else cla)
            k_eff = kb * torch.exp(-cla)
            scores = torch.einsum("bhtd,bhsd->bhts", q_eff, k_eff)
            scores = torch.where(causal, scores, 0.0)
            o = torch.einsum("bhts,bhsd->bhtd", scores, vb)          # intra
            o = o + torch.einsum("bhtd,bhde->bhte", q_eff, s)        # inter
            if mode == "rwkv" and uf is not None:
                diag = torch.einsum("bhtd,hd,bhtd->bht", qb, uf, kb)
                o = o + diag[..., None] * vb
            la_end = cla[..., -1:, :]                    # (B, H, 1, D)
            k_state = kb * torch.exp(la_end - cla)
            s = torch.exp(la_end[..., 0, :, None]) * s + torch.einsum(
                "bhtd,bhte->bhde", k_state, vb)
            outs.append(o)
    o = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(b, l, h, d)
    return o.to(q.dtype), s


def linear_attn_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     log_a: torch.Tensor, s: torch.Tensor, *, mode: str = "gla",
                     u: torch.Tensor | None = None):
    """The exact one-token recurrence.  q, k, v, log_a (B, H, D); s (B, H,
    D, D) float32.  Returns (o (B, H, D) in q's dtype, the new state).  RWKV
    reads the old state (o = q (S + u k^T v), then S <- a S + k^T v); GLA
    updates first and reads the new one."""
    qf, kf, vf = q.float(), k.float(), v.float()
    a = torch.exp(torch.clamp(log_a.float(), min=LOG_A_MIN))
    kv = kf[..., :, None] * vf[..., None, :]         # (B, H, Dk, Dv)
    with full_f32():
        if mode == "rwkv":
            bonus = u.float()[None, :, :, None] if u is not None else 1.0
            wkv = s + bonus * kv
            o = torch.einsum("bhd,bhde->bhe", qf, wkv)
            s_new = a[..., None] * s + kv
        else:
            s_new = a[..., None] * s + kv
            o = torch.einsum("bhd,bhde->bhe", qf, s_new)
    return o.to(q.dtype), s_new
