"""KV caches for serving behind a tagged ``CacheSpec``: the full and ring layouts.

  * full — (B, max_len, Hkv, Dh) K/V + (B, max_len) positions: the
    conventional cache, used when a global layer serves without LPSA.
  * ring — (B, sink+window, Hkv, Dh) + a slot->position map: O(TL_SA)
    memory at any context length (core.lpsa.decode_slot).

A cache is a dict {"k", "v", "pos"} of tensors; position -1 marks an empty
slot.  ``attn_write`` updates the cache in place (the JAX package returns a
new one) — the caches are the engine's largest state and are never shared.
The paged layout and prefix sharing wait for a later slice (ROADMAP).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.lpsa import decode_slot

__all__ = ["CacheSpec", "CACHE_LAYOUTS", "init_cache", "write_slot",
           "attn_write", "attn_read", "ring_from_stream"]

CACHE_LAYOUTS = ("full", "ring")


@dataclass(frozen=True)
class CacheSpec:
    """One layer's serving cache: ``layout`` plus the fields it reads (full:
    max_len; ring: sink + window)."""
    layout: str
    batch: int
    max_len: int = 0
    sink: int = 0
    window: int = 0
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if self.layout not in CACHE_LAYOUTS:
            raise ValueError(f"unknown cache layout {self.layout!r}: the port "
                             f"has {', '.join(CACHE_LAYOUTS)}")

    @property
    def slots(self) -> int:
        return self.max_len if self.layout == "full" else self.sink + self.window


def init_cache(cfg: ModelConfig, spec: CacheSpec, device=None) -> dict:
    """An empty cache (zeros, every position -1) for one layer."""
    shp = (spec.batch, spec.slots, cfg.n_kv_heads, cfg.head_dim_)
    return {"k": torch.zeros(shp, dtype=spec.dtype, device=device),
            "v": torch.zeros(shp, dtype=spec.dtype, device=device),
            "pos": torch.full((spec.batch, spec.slots), -1, dtype=torch.int32,
                              device=device)}


def write_slot(t: torch.Tensor, *, sink: int, window: int, ring: bool) -> torch.Tensor:
    """The cache slot that position t (B,) writes: its ring slot
    (core.lpsa.decode_slot), or t itself in a full cache."""
    return decode_slot(t, sink, window) if ring else t


def attn_write(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
               t: torch.Tensor, slot: torch.Tensor, rows: torch.Tensor) -> dict:
    """Write one token's K/V (B, 1, Hkv, Dh) per sequence in place: row
    rows[b] (int64), slot slot[b] (write_slot), position t[b].  A full cache
    needs t < max_len (the engine checks prompt + generation against max_len
    at submission)."""
    cache["k"][rows, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][rows, slot] = v_new[:, 0].to(cache["v"].dtype)
    cache["pos"][rows, slot] = t.to(torch.int32)
    return cache


def attn_read(cache: dict):
    """-> (k (B, S, Hkv, Dh), v, k_pos (B, S)); empty slots have pos -1."""
    return cache["k"], cache["v"], cache["pos"]


def ring_from_stream(cfg: ModelConfig, state, *, sink: int, window: int) -> dict:
    """Turn core.lpsa.lpsa_prefill's stream buffers into a decode ring.

    state = (k_sink, v_sink, k_win, v_win, t_end): sink slots keep the first
    ``sink`` positions (valid below t_end); ring slot sink + j takes the
    window buffer's position p with p = j (mod window), p in
    [t_end - window, t_end), valid when p >= sink and p >= 0.
    """
    k_sink, v_sink, k_win, v_win, t_end = state
    dtype, dev = k_sink.dtype, k_sink.device
    b = k_sink.shape[0]
    sink_pos = torch.arange(sink, device=dev)
    j = torch.arange(window, device=dev)
    base = t_end - window
    p = base + (j - (base - sink)) % window
    ring_valid = (p >= sink) & (p >= 0)
    idx = torch.clamp(p - base, 0, window - 1)
    k = torch.cat([k_sink.to(dtype), k_win[:, idx].to(dtype)], dim=1)
    v = torch.cat([v_sink.to(dtype), v_win[:, idx].to(dtype)], dim=1)
    pos = torch.cat([torch.where(sink_pos < t_end, sink_pos, -1),
                     torch.where(ring_valid, p, -1)]).to(torch.int32)
    return {"k": k, "v": v, "pos": pos[None].expand(b, -1).contiguous()}
