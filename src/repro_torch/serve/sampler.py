"""Next-token samplers: greedy / temperature / top-k, JAX's random stream.

A copy of the JAX package's ``serve/sampler.py`` in PyTorch, with the parts
of ``jax.random`` it reaches written out: the engine derives each row's key
as ``fold_in(fold_in(PRNGKey(seed), uid), counter)`` and samples
``categorical(key, logits / T)``, an argmax of ``gumbel + logits / T``.  With
``jax_threefry_partitionable`` (JAX's default) that is, bit for bit:

* ``PRNGKey(seed)`` = (0, seed mod 2^32) (64-bit types off);
* ``fold_in(key, d)`` = ``threefry2x32(key, (0, d))`` as a new key pair,
  ``d`` taken as int32 and reinterpreted as uint32;
* the random bits of lane i = ``y0 ^ y1`` of ``threefry2x32(key, (0, i))``;
* the uniform in [tiny, 1): the top 23 bits as a mantissa of [1, 2), minus
  1, plus tiny, at least tiny;
* gumbel = ``-log(-log(u))``.

Everything but the two logs is integer and bit work, so keys, bits and
uniforms equal JAX's exactly on any device; the logs are the device's own
(XLA's CPU log and CUDA's logf differ from torch's CPU log by float32
ulps).  uint32 words are held in int64 tensors, masked to 32 bits, since
PyTorch's uint32 type lacks arithmetic on some devices.

Sampling is deterministic per (request uid, token index), so a request's
tokens do not depend on which other requests share the decode batch.
"""

from __future__ import annotations

import torch

__all__ = ["greedy", "prng_key", "fold_in", "fold_keys", "threefry2x32",
           "random_bits", "uniform", "gumbel", "sample_token", "make_sampler"]

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
TINY = torch.finfo(torch.float32).tiny


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """(..., V) -> (...,) int64: the first index of the largest logit, as
    ``jnp.argmax`` picks."""
    return torch.argmax(logits, dim=-1)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of counter words (x0, x1) under
    key words (k0, k1): uint32 values in int64 tensors that broadcast
    together.  JAX's ``threefry2x32_p``."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as (2,) int64 words: (0, seed mod 2^32)."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64, device=device)


def fold_in(keys: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in`` row by row: keys (..., 2), data (...) integers
    taken as int32 and reinterpreted as uint32 -> keys (..., 2)."""
    d = data.to(torch.int32).to(torch.int64) & MASK32
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def fold_keys(base: torch.Tensor, uids: torch.Tensor, counters: torch.Tensor) -> torch.Tensor:
    """Each row's sampling key ``fold_in(fold_in(base, uid), counter)``:
    base (2,), uids and counters (B,) -> (B, 2) int64 words."""
    return fold_in(fold_in(base.expand(uids.shape[0], 2), uids), counters)


def random_bits(keys: torch.Tensor, width: int) -> torch.Tensor:
    """32 random bits for each of ``width`` lanes of each key: keys (B, 2)
    -> (B, width) int64 in [0, 2^32).  Lane i hashes the counter (0, i)."""
    lanes = torch.arange(width, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(keys[:, :1], keys[:, 1:], torch.zeros_like(lanes), lanes)
    return y0 ^ y1


def uniform(keys: torch.Tensor, width: int) -> torch.Tensor:
    """``jax.random.uniform(key, (width,), minval=tiny)`` for each key:
    float32 (B, width) in [tiny, 1)."""
    mant = (random_bits(keys, width) >> 9) | 0x3F800000
    floats = mant.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(floats + TINY, TINY)


def gumbel(keys: torch.Tensor, width: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (width,))`` (mode "low") for each key."""
    return -torch.log(-torch.log(uniform(keys, width)))


def sample_token(logits: torch.Tensor, keys: torch.Tensor, temperature: torch.Tensor,
                 top_k: int = 0) -> torch.Tensor:
    """Rows of logits (B, V) float32, keys (B, 2), temperatures (B,) ->
    token ids (B,) int64.

    Temperature <= 0 selects the greedy argmax; otherwise a draw from the
    softmax at that temperature (``jax.random.categorical``), restricted to
    the logits at least the ``top_k``-th largest value when top_k > 0 (every
    tie of that value is kept)."""
    greedy_ids = greedy(logits)
    if top_k and top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits >= kth, logits, float("-inf"))
    t = temperature.to(torch.float32)
    # a true division: jitted, XLA keeps it one (no product with 1 / T)
    scaled = logits / torch.clamp_min(t, 1e-6)[:, None]
    drawn = torch.argmax(gumbel(keys, logits.shape[-1]) + scaled, dim=-1)
    return torch.where(t > 0, drawn, greedy_ids)


def make_sampler(top_k: int = 0):
    """Batched sampler: (logits (B, V), keys (B, 2), temps (B,)) -> (B,) int64."""
    def sampler(logits, keys, temps):
        return sample_token(logits, keys, temps, top_k)
    return sampler
