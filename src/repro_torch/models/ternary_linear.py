"""TernaryLinear, serving half: base-3 packed weights behind the DAS kernels.

Export (``export_tlin``) quantizes a master weight (K, N) to trits and packs
them along K with the packed rows padded to a multiple of 16 — the JAX
package's export format.  The padding lanes decode to zero trits, so the
kernels contract over all 5R lanes with zero activations past K and compute
exactly the reference function; every projection of bitnet-1.3b therefore
runs on a kernel (in the JAX package none reaches its Pallas GEMM at full
width, since those require 5R == K).

Serving dispatch (``tlin_apply``), with DAS on:

  * 32 | K:  DAS-compact (``das_topk``) -> ``das_ternary_gemm``;
  * else:    DAS-mask with the dense tail (``das_topk``) -> ``ternary_gemm``;

and ``ternary_gemm`` on the raw activations with DAS off.  ``tlin_compact``
runs the DAS step once for projections that share an input (q/k/v,
gate/up).  The output is cast back to x's dtype.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import TernaryConfig
from repro_torch.core import ternary as tq
from repro_torch.core import twd
from repro_torch.kernels import ops

__all__ = ["ROW_ALIGN", "TernaryLinear", "tlin_init", "export_tlin",
           "tlin_compact", "tlin_apply"]

ROW_ALIGN = 16   # packed rows of an export are a multiple of this


class TernaryLinear(nn.Module):
    """Serving form of one ternary linear: ``packed`` (R, N) uint8 and the
    float32 ``scale``, for a logical (d_in, d_out) weight."""

    def __init__(self, d_in: int, d_out: int, tc: TernaryConfig, device=None):
        super().__init__()
        if not tc.enabled or tc.serve_format != "packed":
            raise NotImplementedError(
                "the port serves base-3 packed ternary weights only "
                f"(enabled={tc.enabled}, serve_format={tc.serve_format!r})")
        self.d_in, self.d_out, self.tc = d_in, d_out, tc
        rows = twd.packed_rows(d_in, ROW_ALIGN)
        self.register_buffer("packed", torch.zeros((rows, d_out), dtype=torch.uint8,
                                                   device=device))
        self.register_buffer("scale", torch.ones((), dtype=torch.float32,
                                                 device=device))

    def forward(self, x: torch.Tensor, ca: ops.DasTopK | None = None) -> torch.Tensor:
        return tlin_apply(self, x, ca)


def tlin_init(gen: torch.Generator, d_in: int, d_out: int, dtype: torch.dtype,
              scale: float | None = None) -> dict:
    """Master weight {"w": (d_in, d_out)} ~ N(0, scale^2), default d_in^-1/2."""
    s = scale if scale is not None else d_in ** -0.5
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=gen.device) * s
    return {"w": w.to(dtype)}


def export_tlin(p: dict, tc: TernaryConfig) -> dict:
    """Master {"w"} -> serving {"packed" (R, N) uint8, "scale" float32}."""
    if not tc.enabled or tc.serve_format != "packed":
        raise NotImplementedError("the port exports base-3 packed weights only")
    tw = tq.ternary_quantize(p["w"])
    return {"packed": twd.pack_ternary(tw.values, row_align=ROW_ALIGN),
            "scale": tw.scale}


def tlin_compact(x: torch.Tensor, tc: TernaryConfig) -> ops.DasTopK | None:
    """The DAS step of x's flattened rows, or None with DAS off."""
    if tc.das is None:
        return None
    return ops.das_topk(x, keep=tc.das.keep, block=tc.das.block)


def tlin_apply(lin: TernaryLinear, x: torch.Tensor,
               ca: ops.DasTopK | None = None) -> torch.Tensor:
    """x (..., K) -> (..., N) in x's dtype; ``ca`` is a shared DAS step of x."""
    k = x.shape[-1]
    lead = x.shape[:-1]
    if lin.tc.das is None:
        y = ops.ternary_gemm(x.reshape(-1, k).contiguous(), lin.packed, lin.scale)
    else:
        if ca is None:
            ca = tlin_compact(x, lin.tc)
        if ca.values is not None:
            y = ops.das_ternary_gemm(ca.values, ca.indices, lin.packed, lin.scale)
        else:
            y = ops.ternary_gemm(ca.dense, lin.packed, lin.scale)
    return y.reshape(*lead, y.shape[-1]).to(x.dtype)
