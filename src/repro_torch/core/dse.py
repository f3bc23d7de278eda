"""Design Space Exploration (paper Sec. IV-D, Eqs. 4-7).

Grid search minimizing  L(C) = PPL * L_power * L_latency  over the
hyper-parameter vector C = (P_L, P_H, TL_SA [, S_a]) subject to the
pipeline-hiding constraint  P_L / P_H < D_m / TL_SA  (Eq. 7) — the STL-core
latency for a Q projection must cover the HP-core latency for the sparse
QK^T row so attention stays hidden (Fig 10c).

The PPL term interpolates the paper's ablation measurements (Fig 11 /
Tables II-III); the power term follows Eq. 5 with per-core and KV-buffer
power coefficients calibrated against Table IV; latency follows the
perfmodel roofline (Eq. 6).

A TPU-facing variant swaps (P_L, P_H) for (pack size C, TL_SA, S_a): on a
single-chip temporal pipeline the constraint becomes a roofline-balance
condition  t_attn(C, TL_SA) <= t_proj(C, S_a).  It keeps its name
(``tpu_dse_grid_search``) and takes any one-chip profile as ``hw``: the
TPU's, or the H100's (core/perfmodel.py ``H100_SXM``).

A copy of the JAX package's ``core/dse.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import product
from typing import Iterable

import numpy as np

from .perfmodel import (HardwareSpec, ModelShape, TenetOpt, stage_cost)

__all__ = [
    "PPL_TABLE", "ppl_model", "DseCandidate", "dse_grid_search",
    "tpu_dse_grid_search",
]

# --- measured algorithm points (paper Tables II/III, Fig 11) ---------------
# (model, S_a)   -> wikitext2/c4 PPL.  S_a = 1.0 means dense BitNet.
PPL_TABLE = {
    ("bitnet-1.3b", 1.00): 11.27,
    ("bitnet-1.3b", 0.50): 11.32,
    ("bitnet-1.3b", 0.375): 11.90,
    ("bitnet-1.3b", 0.25): 13.40,   # Fig 11: sharp knee at S_a = 3/4 dropped
    ("bitnet-3b", 1.00): 9.71,
    ("bitnet-3b", 0.50): 9.90,
    ("bitnet-3b", 0.375): 10.30,
    ("bitnet-3b", 0.25): 11.10,
}
# TL_SA sensitivity (Fig 11 right): marginal 512 -> 1536.
TLSA_PPL_DELTA = {512: +0.12, 768: +0.05, 1024: 0.0, 1280: -0.02, 1536: -0.03}


def ppl_model(model_name: str, s_a: float, tl_sa: int) -> float:
    """Interpolated PPL(S_a, TL_SA) from the paper's ablation data."""
    pts = sorted((sa, p) for (m, sa), p in PPL_TABLE.items() if m == model_name)
    if not pts:
        raise KeyError(f"no PPL data for {model_name}")
    xs = np.array([p[0] for p in pts])
    ys = np.array([p[1] for p in pts])
    base = float(np.interp(s_a, xs, ys))
    ks = sorted(TLSA_PPL_DELTA)
    dl = float(np.interp(tl_sa, ks, [TLSA_PPL_DELTA[k] for k in ks]))
    return base + dl


# --- hardware-side models (Eq. 5 coefficients calibrated to Table IV) ------
P_STL_CORE_W = 0.672 / 16    # 672 mW for 16 cores
P_HP_CORE_W = 3.3152 / 4     # 3315.2 mW for 4 cores
P_KV_BUF_W_PER_KB = 0.4017 / 1408  # buffer power scales ~linearly with KB
P_CONST_W = 0.6379 + 0.2248 + 0.3919 + 0.0262 + 0.0201  # SNU+SFU+TMI+misc
CORE_TOPS = 32 * 64 * 2 * 0.5e-3   # TOPS per 32x64 core @ 500 MHz = 2.048


@dataclass(frozen=True)
class DseCandidate:
    p_l: int
    p_h: int
    tl_sa: int
    s_a: float
    ppl: float
    power_w: float
    latency_s: float
    objective: float
    feasible: bool


def _candidate(m: ModelShape, model_name: str, p_l: int, p_h: int,
               tl_sa: int, s_a: float, decode_tl: int) -> DseCandidate:
    ppl = ppl_model(model_name, s_a, tl_sa)
    kv_kb = tl_sa * m.n_kv_heads * m.head_dim * 2 * 2 / 1024  # K+V fp16
    power = (p_l * P_STL_CORE_W + p_h * P_HP_CORE_W
             + kv_kb * P_KV_BUF_W_PER_KB + P_CONST_W)
    hw = HardwareSpec("dse", CORE_TOPS * p_l, CORE_TOPS * p_h, 512.0, power,
                      onchip_mb=1.4)
    opt = TenetOpt(weight_bits=1.6, das=s_a < 1.0, s_a=s_a, lpsa=True,
                   tl_sa=tl_sa)
    c = stage_cost(m, "decode", decode_tl, opt)
    t_low = c.flops_low / (hw.peak_tops_low * 1e12)
    t_high = c.flops_high / (hw.peak_tops_high * 1e12)
    t_mem = c.bytes / (hw.hbm_gbps * 1e9)
    latency = max(t_low, t_high, t_mem)
    feasible = (p_l / p_h) < (m.d_model / tl_sa)          # Eq. 7
    objective = ppl * power * latency
    return DseCandidate(p_l, p_h, tl_sa, s_a, ppl, power, latency, objective,
                        feasible)


def dse_grid_search(m: ModelShape, model_name: str, *,
                    p_l_grid: Iterable[int] = (8, 12, 16, 24, 32),
                    p_h_grid: Iterable[int] = (2, 4, 6, 8),
                    tl_sa_grid: Iterable[int] = (512, 1024, 1536),
                    s_a_grid: Iterable[float] = (1.0, 0.5, 0.25),
                    decode_tl: int = 2048) -> list[DseCandidate]:
    """Paper's DSE: returns feasible candidates sorted by objective (Eq. 4)."""
    out = [
        _candidate(m, model_name, pl, ph, tl, sa, decode_tl)
        for pl, ph, tl, sa in product(p_l_grid, p_h_grid, tl_sa_grid, s_a_grid)
    ]
    feas = [c for c in out if c.feasible]
    return sorted(feas, key=lambda c: c.objective)


# --------------------------------------------------------------------------
# TPU variant: pick (chunk C, TL_SA, S_a) so attention hides under projection
# --------------------------------------------------------------------------

def tpu_dse_grid_search(m: ModelShape, model_name: str, hw: HardwareSpec, *,
                        chunk_grid: Iterable[int] = (128, 256, 512),
                        tl_sa_grid: Iterable[int] = (512, 1024, 1536),
                        s_a_grid: Iterable[float] = (1.0, 0.5),
                        ) -> list[dict]:
    """Balance t_attn(C, TL_SA) vs t_proj(C, S_a) on one TPU chip.

    Returns dicts sorted by PPL * latency-per-token (power is constant on a
    fixed chip, so Eq. 4 degenerates to PPL * latency).
    """
    d, res = m.d_model, []
    lin_per_tok = 2.0 * m.linear_params()
    for c, tl_sa, s_a in product(chunk_grid, tl_sa_grid, s_a_grid):
        t_proj = lin_per_tok * s_a / (hw.peak_tops_low * 1e12)
        att_ops = 2.0 * 2.0 * m.n_heads * m.head_dim * tl_sa * m.n_layers
        t_attn = att_ops / (hw.peak_tops_high * 1e12)
        hidden = t_attn <= t_proj
        ppl = ppl_model(model_name, s_a, tl_sa)
        lat = max(t_proj, t_attn)
        res.append(dict(chunk=c, tl_sa=tl_sa, s_a=s_a, ppl=ppl,
                        t_proj=t_proj, t_attn=t_attn, hidden=hidden,
                        objective=ppl * lat))
    return sorted(res, key=lambda r: r["objective"])
