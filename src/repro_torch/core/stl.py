"""STL — Sparse Ternary LUT core semantics (paper Sec. III-A/B/D, Table I),
on tensors.

The JAX package's ``core/stl.py`` in PyTorch.  The STL core computes a
ternary mpGEMM tile via a *zero-aware symmetric precompute table*:
activations are grouped in pairs {a, b} (g = 2); the shared table holds the
four dense partial products {a+b, a-b, a, b}; each ternary weight pair (w0,
w1) decodes into

    GIdx (1b)  — asserted when the whole group is zero (gates the PE),
    DIdx (2b)  — selects one of the four symmetric partial products,
    SIdx (1b)  — mirrors the sign (the "negative half" of the 3^2-1=8 cases).

This module is the *algorithm-level oracle* of that datapath, not a kernel:
the JAX package has no Pallas STL kernel either.  ``stl_matmul_ref`` routes
every partial product through (GIdx, DIdx, SIdx) exactly as the PE pipeline
does and equals a plain matmul exactly on integer-valued inputs.  Its
complexity model (Table I) is reproduced analytically in
``core_complexity``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = [
    "GROUP",
    "StlEncoding",
    "stl_encode",
    "stl_decode_dot",
    "stl_matmul_ref",
    "core_complexity",
]

GROUP = 2  # g — activations per group; fixed to 2 by the PE design


class StlEncoding(NamedTuple):
    """Per weight-group control tuple (paper Fig. 5(b))."""

    gidx: torch.Tensor  # (G, N) bool   — group-is-all-zero gate
    didx: torch.Tensor  # (G, N) int64  — 0:a+b 1:a-b 2:a 3:b
    sidx: torch.Tensor  # (G, N) bool   — sign mirror


# (w0+1)*3 + (w1+1)  ->  (gidx, didx, sidx); table ordered for w in {-1,0,1}^2
#   w pair     dot        enc
#   (-1,-1)  -(a+b)   (0, 0, 1)
#   (-1, 0)  -a       (0, 2, 1)
#   (-1, 1)  -(a-b)   (0, 1, 1)
#   ( 0,-1)  -b       (0, 3, 1)
#   ( 0, 0)   0       (1, 0, 0)
#   ( 0, 1)   b       (0, 3, 0)
#   ( 1,-1)   a-b     (0, 1, 0)
#   ( 1, 0)   a       (0, 2, 0)
#   ( 1, 1)   a+b     (0, 0, 0)
_GIDX = (0, 0, 0, 0, 1, 0, 0, 0, 0)
_DIDX = (0, 2, 1, 3, 0, 3, 1, 2, 0)
_SIDX = (1, 1, 1, 1, 0, 0, 0, 0, 0)


def stl_encode(w: torch.Tensor) -> StlEncoding:
    """Encode ternary weights (K, N) into per-group (GIdx, DIdx, SIdx).

    K must be even (groups of 2 along K).
    """
    k, n = w.shape
    if k % GROUP != 0:
        raise ValueError(f"K={k} must be a multiple of the STL group size {GROUP}")
    wp = w.to(torch.int64).reshape(k // GROUP, GROUP, n)
    code = (wp[:, 0] + 1) * 3 + (wp[:, 1] + 1)  # (G, N) in [0, 9)
    table = lambda t, dt: torch.tensor(t, dtype=dt, device=w.device)[code]  # noqa: E731
    return StlEncoding(gidx=table(_GIDX, torch.bool), didx=table(_DIDX, torch.int64),
                       sidx=table(_SIDX, torch.bool))


def _precompute_table(x: torch.Tensor) -> torch.Tensor:
    """Shared mirror-half precompute table for grouped activations.

    x: (..., K) -> table (..., G, 4) holding [a+b, a-b, a, b] per group.
    One adder ("mirror-half pre-compute adder logic") per group builds it;
    the negative mirrors come from SIdx, never stored (the zero-aware trick).
    """
    g = x.shape[-1] // GROUP
    xg = x.reshape(x.shape[:-1] + (g, GROUP))
    a, b = xg[..., 0], xg[..., 1]
    return torch.stack([a + b, a - b, a, b], dim=-1)


def stl_decode_dot(x: torch.Tensor, enc: StlEncoding) -> torch.Tensor:
    """Compute x @ W via the STL pipeline: table lookup -> sign -> zero gate.

    x: (..., K) float; enc encodes W (K, N).  Returns (..., N).
    """
    table = _precompute_table(x)  # (..., G, 4)
    # lookup: DIdx steers the 4:1 mux per (group, out-channel); a one-hot
    # select, so it stays exact
    onehot = torch.nn.functional.one_hot(enc.didx, 4).to(table.dtype)  # (G, N, 4)
    sel = torch.einsum("...gf,gnf->...gn", table, onehot)              # (..., G, N)
    signed = torch.where(enc.sidx, -sel, sel)       # SIdx mirror
    gated = torch.where(enc.gidx, torch.zeros_like(signed), signed)   # GIdx zero gate
    return torch.sum(gated, dim=-2)                 # adder tree over G


def stl_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Full STL-core mpGEMM oracle; equals x @ w exactly on integer-valued
    inputs (float arithmetic)."""
    return stl_decode_dot(x, stl_encode(w.to(torch.int8)))


# --------------------------------------------------------------------------
# Table I — compute-core complexity model (units: primitive ops / table slots)
# --------------------------------------------------------------------------

def core_complexity(core: str, *, n_t: int, g_total: int, g: int = GROUP,
                    s_a: float = 1.0) -> dict[str, float]:
    """Complexity terms of the four A8W1.58 core designs (paper Table I).

    Parameters mirror the paper: N_t output channels, G = K_t/g groups,
    group size g, activation density S_a (<1 only for STL).
    Returns dict with precompute / lookup / adder costs.
    """
    G = float(g_total)
    if core == "add_only":
        return {"precompute": 0.0, "lookup": 0.0, "adder": n_t * G * g}
    if core == "general_lut":  # bit-serial INT2 (2 one-bit planes)
        return {"precompute": G * (2 ** g) * g / n_t,
                "lookup": 2 * n_t * G * (2 ** g),
                "adder": n_t * (G + g)}
    if core == "ternary_lut":  # base-3 element-wise table
        return {"precompute": G * (3 ** g) * g / n_t,
                "lookup": n_t * G * (3 ** g),
                "adder": n_t * G}
    if core == "stl":          # ours: symmetric zero-aware table + DAS
        return {"precompute": s_a * G * (2 ** g) * g / n_t,
                "lookup": s_a * n_t * G * (2 ** g),
                "adder": s_a * n_t * G}
    raise ValueError(f"unknown core {core!r}")
