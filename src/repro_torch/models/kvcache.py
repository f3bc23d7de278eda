"""Slot caches for serving behind a tagged ``CacheSpec``: full, ring and
paged KV caches for attention, and the recurrent states of mamba, rwkv and
gla.

  * full — (B, max_len, Hkv, Dh) K/V + (B, max_len) positions: the
    conventional cache, used when a global layer serves without LPSA.
  * ring — (B, sink+window, Hkv, Dh) + a slot->position map: O(TL_SA)
    memory at any context length (core.lpsa.decode_slot).
  * paged — one (num_pages, page_size, Hkv, Dh) K/V arena + a
    (num_pages, page_size) position map, shared by every sequence and
    addressed through per-sequence int32 page tables (B, pages_per_seq).
    Page 0 is the null page: unmapped table entries point at it and its
    positions stay -1, so reads through them are masked.

  * mamba — {"conv" (B, cw - 1, d_inner), "ssm" (B, nh, hd, N), and the
    chunk-replay buffers "ssd_x" (B, chunk, nh, hd), "ssd_b", "ssd_c" (B,
    chunk, N), "ssd_dt" (B, chunk, nh)}, float32 (``mamba2.init_state``).
  * rwkv — {"wkv" (B, H, hd, hd), "shift_t", "shift_c" (B, 1, D)}, float32.
  * gla — {"s" (B, H, hd, hd)}, float32.

A per-sequence KV cache is a dict {"k", "v", "pos"} of tensors, an arena
{"k_pages", "v_pages", "pos_pages"}; position -1 marks an empty slot.  The
recurrent states are O(1) a slot and take no position.  The token shifts
and the conv's inputs hold bfloat16 values in a model of that dtype (the
JAX package's eager step returns them in x's dtype); float32 holds them
exactly, so both give the same tokens, and the port keeps float32, as the
JAX package's ``init_cache`` allocates them.
``attn_write`` updates a cache in place (the JAX package returns a new one):
the engine's CUDA graph holds the caches' storage, so nothing rebinds them.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.lpsa import decode_slot
from repro_torch.models import mamba2

__all__ = ["CacheSpec", "CACHE_LAYOUTS", "init_cache", "is_paged", "write_slot",
           "attn_write", "attn_read", "ring_from_stream"]

CACHE_LAYOUTS = ("full", "ring", "paged", "mamba", "rwkv", "gla")


@dataclass(frozen=True)
class CacheSpec:
    """One layer's serving cache: ``layout`` plus the fields it reads (full:
    max_len; ring: sink + window; paged: page_size + num_pages, the arena
    itself batch-free; mamba, rwkv and gla: batch only)."""
    layout: str
    batch: int
    max_len: int = 0
    sink: int = 0
    window: int = 0
    page_size: int = 0
    num_pages: int = 0
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if self.layout not in CACHE_LAYOUTS:
            raise ValueError(f"unknown cache layout {self.layout!r}: the port "
                             f"has {', '.join(CACHE_LAYOUTS)}")
        if self.layout == "paged" and (self.page_size < 1 or self.num_pages < 2):
            raise ValueError(
                "paged cache needs page_size >= 1 and num_pages >= 2 "
                f"(page 0 is the reserved null page); got page_size="
                f"{self.page_size}, num_pages={self.num_pages}")

    @property
    def slots(self) -> int:
        return self.max_len if self.layout == "full" else self.sink + self.window


def init_cache(cfg: ModelConfig, spec: CacheSpec, device=None) -> dict:
    """An empty cache (zeros, every position -1) for one layer."""
    f32, hd = torch.float32, cfg.head_dim_
    if spec.layout == "mamba":
        return mamba2.init_state(cfg, spec.batch, device)
    if spec.layout == "rwkv":
        return {"wkv": torch.zeros((spec.batch, cfg.n_heads, hd, hd), dtype=f32, device=device),
                "shift_t": torch.zeros((spec.batch, 1, cfg.d_model), dtype=f32, device=device),
                "shift_c": torch.zeros((spec.batch, 1, cfg.d_model), dtype=f32, device=device)}
    if spec.layout == "gla":
        return {"s": torch.zeros((spec.batch, cfg.n_heads, hd, hd), dtype=f32, device=device)}
    kv = (cfg.n_kv_heads, hd)
    if spec.layout == "paged":
        shp = (spec.num_pages, spec.page_size)
        return {"k_pages": torch.zeros(shp + kv, dtype=spec.dtype, device=device),
                "v_pages": torch.zeros(shp + kv, dtype=spec.dtype, device=device),
                "pos_pages": torch.full(shp, -1, dtype=torch.int32, device=device)}
    shp = (spec.batch, spec.slots)
    return {"k": torch.zeros(shp + kv, dtype=spec.dtype, device=device),
            "v": torch.zeros(shp + kv, dtype=spec.dtype, device=device),
            "pos": torch.full(shp, -1, dtype=torch.int32, device=device)}


def is_paged(cache: dict) -> bool:
    return "k_pages" in cache


def write_slot(t: torch.Tensor, *, sink: int, window: int, ring: bool) -> torch.Tensor:
    """The cache slot that position t (B,) writes: its ring slot
    (core.lpsa.decode_slot), or t itself in a full cache."""
    return decode_slot(t, sink, window) if ring else t


def attn_write(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
               t: torch.Tensor, slot: torch.Tensor, rows: torch.Tensor,
               page_table: torch.Tensor | None = None) -> dict:
    """Write one token's K/V (B, 1, Hkv, Dh) per sequence in place: row
    rows[b] (int64), slot slot[b] (write_slot), position t[b].  A full cache
    needs t < max_len (the engine checks prompt + generation against max_len
    at submission).  An arena takes ``page_table`` (B, pages_per_seq) int32
    instead of rows and slots (``_paged_write``)."""
    if is_paged(cache):
        return _paged_write(cache, k_new, v_new, t, rows, page_table)
    cache["k"][rows, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][rows, slot] = v_new[:, 0].to(cache["v"].dtype)
    cache["pos"][rows, slot] = t.to(torch.int32)
    return cache


def _paged_write(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                 t: torch.Tensor, rows: torch.Tensor,
                 page_table: torch.Tensor | None) -> dict:
    """Position t[b] of row rows[b] lands in page ``page_table[b, t //
    page_size]`` at offset ``t % page_size``; rows with t < 0 (inactive) go
    to the null page 0 with position -1, so they never touch a page in use."""
    if page_table is None:
        raise ValueError("paged cache write requires a page_table")
    ps = cache["k_pages"].shape[1]
    t = t.to(torch.int64)
    valid = t >= 0
    tv = torch.where(valid, t, 0)
    phys = torch.where(valid, page_table[rows, tv // ps].to(torch.int64), 0)
    off = tv % ps
    cache["k_pages"][phys, off] = k_new[:, 0].to(cache["k_pages"].dtype)
    cache["v_pages"][phys, off] = v_new[:, 0].to(cache["v_pages"].dtype)
    cache["pos_pages"][phys, off] = torch.where(valid, t, -1).to(torch.int32)
    return cache


def attn_read(cache: dict, page_table: torch.Tensor | None = None):
    """-> (k (B, S, Hkv, Dh), v, k_pos (B, S)); empty slots have pos -1.

    An arena is gathered through ``page_table``: S = pages_per_seq *
    page_size and gathered index i is absolute position i (logical page j
    holds positions [j * page_size, (j + 1) * page_size)), so the view is
    laid out as a full cache and the attention is the same."""
    if not is_paged(cache):
        return cache["k"], cache["v"], cache["pos"]
    if page_table is None:
        raise ValueError("paged cache read requires a page_table")
    b, n = page_table.shape
    pt = page_table.to(torch.int64)
    kp, vp, pp = cache["k_pages"], cache["v_pages"], cache["pos_pages"]
    s = n * kp.shape[1]
    return (kp[pt].reshape(b, s, *kp.shape[2:]), vp[pt].reshape(b, s, *vp.shape[2:]),
            pp[pt].reshape(b, s))


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
