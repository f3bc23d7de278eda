"""LPSA — sink + window sparse attention and its pack dataflow (Sec. IV-B).

Position p_q attends p_k  <=>  p_k <= p_q  AND  (p_k < sink OR p_q - p_k < window),
so TL_SA = sink + window slots hold every key a decode step can see.

``lpsa_prefill`` is the paper's Algorithm 1 on tensors: the sequence goes
through in packs of C tokens; each pack's q/k/v come from the caller's
projection and attend to ``[sink | window | pack]`` keys at once.  Key slots
that do not hold a visible token (a sink slot not yet reached by an earlier
pack, a window slot before position ``sink`` or before 0) carry position -1,
which the attention mask treats as empty — the same set of keys as the JAX
package's ``lpsa_allowed & valid`` mask.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

__all__ = ["LpsaSpec", "lpsa_allowed", "decode_slot", "pack_positions", "lpsa_prefill"]


class LpsaSpec(NamedTuple):
    sink: int = 128
    window: int = 896
    chunk: int = 256


def lpsa_allowed(q_pos: torch.Tensor, k_pos: torch.Tensor, sink: int,
                 window: int) -> torch.Tensor:
    """Boolean attend-permission for broadcastable position tensors."""
    return (k_pos <= q_pos) & ((k_pos < sink) | (q_pos - k_pos < window))


def decode_slot(pos: torch.Tensor, sink: int, window: int) -> torch.Tensor:
    """Ring-cache slot of an absolute position: sink slots are pinned, the
    window is a ring.  Slot layout: [0, sink) sink, [sink, sink+window) ring."""
    return torch.where(pos < sink, pos, sink + (pos - sink) % window)


def pack_positions(t0: int, spec: LpsaSpec, device=None):
    """The positions of the pack starting at t0: the pack's own (C,) and its
    keys ``[sink | window | pack]`` (S + W + C,), -1 for a sink slot not yet
    reached or a window slot before position ``sink`` or before 0."""
    s, w, c = spec.sink, spec.window, spec.chunk
    sink_slot = torch.arange(s, device=device)
    win_pos = t0 - w + torch.arange(w, device=device)
    pos = torch.arange(t0, t0 + c, device=device)
    k_pos = torch.cat([torch.where(sink_slot < t0, sink_slot, -1),
                       torch.where((win_pos >= s) & (win_pos >= 0), win_pos, -1), pos])
    return pos, k_pos


def lpsa_prefill(x: torch.Tensor, qkv_proj: Callable, *, spec: LpsaSpec,
                 num_q_heads: int, num_kv_heads: int, head_dim: int,
                 rope: Callable | None, softcap: float | None,
                 attend: Callable):
    """Pack-chunked projection + sparse attention over x (B, TL, Dm).

    ``qkv_proj(pack)`` -> q (B, C, Hq, D), k/v (B, C, Hkv, D);
    ``rope(t, pos)`` rotates by absolute positions; ``attend(q, k, v, q_pos,
    k_pos, sink=, window=, softcap=)`` is the attention (kernels/ops
    ``sparse_attention``).  Returns (y (B, TL, Hq, D), state) with state =
    (k_sink, v_sink, k_win, v_win, t_end), the stream buffers that
    models/kvcache.ring_from_stream turns into the decode ring.
    """
    b, tl, _ = x.shape
    s, w, c = spec.sink, spec.window, spec.chunk
    if tl % c:
        raise ValueError(f"TL={tl} must be divisible by the pack size C={c}")
    dev, dt = x.device, x.dtype
    kv = lambda n: torch.zeros((b, n, num_kv_heads, head_dim), dtype=dt,  # noqa: E731
                               device=dev)
    k_sink, v_sink, k_win, v_win = kv(s), kv(s), kv(w), kv(w)
    outs = []
    for t0 in range(0, tl, c):
        q, k, v = qkv_proj(x[:, t0:t0 + c])
        pos, k_pos = pack_positions(t0, spec, dev)
        if rope is not None:
            q, k = rope(q, pos), rope(k, pos)
        # sink slots [t0, min(s, t0 + c)) take this pack's leading tokens
        hi = min(s, t0 + c)
        if t0 < hi:
            k_sink[:, t0:hi] = k[:, :hi - t0]
            v_sink[:, t0:hi] = v[:, :hi - t0]
        o = attend(q, torch.cat([k_sink, k_win, k], 1),
                   torch.cat([v_sink, v_win, v], 1),
                   pos.to(torch.int32)[None].expand(b, c).contiguous(),
                   k_pos.to(torch.int32)[None].expand(b, -1).contiguous(),
                   sink=s, window=w, softcap=softcap)
        outs.append(o)
        if c >= w:
            k_win, v_win = k[:, c - w:], v[:, c - w:]
        else:
            k_win = torch.cat([k_win[:, c:], k], 1)
            v_win = torch.cat([v_win[:, c:], v], 1)
    y = torch.cat(outs, 1).reshape(b, tl, num_q_heads, head_dim)
    return y, (k_sink, v_sink, k_win, v_win, tl)
