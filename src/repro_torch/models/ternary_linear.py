"""TernaryLinear: ternary weights behind the DAS kernels (serving), and
the master-weight QAT path (training).

Two serving forms, chosen by ``TernaryConfig.serve_format``:

  * "packed": base-3 packed (TWD, 1.6 bits/weight);
  * "int8" and "bf16": int8-resident trits (d_in, d_out), one byte a weight
    — the paper's naive INT8 baseline.  Both store the same int8 trits, as
    in the JAX package's export.

Export (``export_tlin``) quantizes a master weight (K, N) to trits; the
packed form packs them along K with the packed rows padded to a multiple of
16 — the JAX package's export format.  The padding lanes decode to zero
trits, so the kernels contract over all 5R lanes with zero activations past
K and compute exactly the reference function; every projection of
bitnet-1.3b therefore runs on a kernel (in the JAX package none reaches its
Pallas GEMM at full width, since those require 5R == K).

Serving dispatch (``tlin_apply``), with DAS on:

  * 32 | K:  DAS-compact (``das_topk``) -> ``das_ternary_gemm`` (packed)
             or ``das_gemv`` (trits);
  * else:    DAS-mask with the dense tail (``das_topk``) -> ``ternary_gemm``
             (packed) or ``das_gemv`` on dense rows (trits);

and the same GEMMs on the raw activations with DAS off.  Under the "tuned"
kernel mode (kernels/ops.py ``kernel_mode``) the packed GEMMs take the
config the autotune cache holds for their shape (kernels/autotune.py
``run_gemm`` / ``run_das_gemm``): a kernel at a launch config or a native
implementation, the masked dense rows for the native dense impls coming
from the same ``das_topk`` step; the int8-trits path keeps ``das_gemv``'s
one config.  A row-parallel
shard (``mesh`` set: wo, w_out or a shared expert's down projection under a
Topology's "model" axis) sums its float32 partial over that axis before
the cast to x's dtype, so a bfloat16 output is rounded once, as on one
device; ``shard_tlin`` cuts a linear's shard, and each shard takes the
route of its own K (bitnet-1.3b's down projection at tp 2: rank 0's 2720
lanes compact, rank 1's 2740 carry the dense tail).  ``tlin_compact``
runs the DAS step once for projections that share an input (q/k/v,
gate/up); ``tlin_norm_input`` does it for projections fed by an rmsnorm,
with the norm run inside the ``das_topk`` kernel.  The output is cast back
to x's dtype.  The trits form applies the scale rounded to x's dtype, as
the JAX package multiplies ``trits.astype(x.dtype) * scale.astype(x.dtype)``;
the packed form keeps the float32 scale, as the JAX package's packed path
does.

Training (master {"w"} leaves; the JAX package's ``tlin_apply`` on "w"):
``tlin_train_input`` takes x through the DAS mask (a constant: the gradient
flows through the surviving lanes only) and the int8 STE fake-quant, once
for every projection that shares x; ``tlin_train`` multiplies that by the
STE ternary fake-quant of w, in x's dtype (``torch.matmul``: the JAX
package's einsum, outside any kernel).  The mask comes from the
``das_topk`` kernel (mask only) where x lies on the card, from its plain
version on the CPU.

Training on a tensor-parallel shard (a ``distributed.plan.Mesh`` with a
"model" axis of more than one rank): ``shard_scales`` gives every
model-sharded master weight of a rank's tree the whole weight's absmean
scale (one float32 all-reduce of each weight's sum of |W| and count, for
the whole tree); ``tlin_train_input(x, tc, mesh)`` takes a row-parallel
input (K cut over "model": wo's heads, the FFN down's d_ff) through the
DAS mask of its own lanes (``das_topk`` on the shard: the cut keeps DAS
blocks whole) and the int8 fake-quant at the row's absmax over "model" (a
MAX all-reduce: exact); ``tlin_train(..., partial=True)`` returns a
row-parallel shard's float32 partial, which the block sums over "model"
before the cast to x's dtype, as serving does.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import TernaryConfig
from repro_torch.core import das as das_lib
from repro_torch.core import ternary as tq
from repro_torch.core import twd
from repro_torch.distributed import collectives
from repro_torch.distributed.plan import tree_leaves
from repro_torch.distributed.sharding import leaf_spec
from repro_torch.kernels import autotune, ops
from repro_torch.models.layers import rmsnorm

__all__ = ["ROW_ALIGN", "TRITS_FORMATS", "TernaryLinear", "check_format", "tlin_init",
           "export_tlin", "shard_tlin", "tlin_compact", "tlin_norm_input", "tlin_apply",
           "das_train_mask", "shard_scales", "tlin_train_input", "tlin_train"]

ROW_ALIGN = twd.ROW_ALIGN   # packed rows of an export are a multiple of this
TRITS_FORMATS = ("int8", "bf16")   # serve formats that hold int8 trits


def check_format(tc: TernaryConfig) -> None:
    if not tc.enabled or tc.serve_format not in ("packed", *TRITS_FORMATS):
        raise NotImplementedError(
            "the port serves ternary weights base-3 packed or as int8 trits "
            f"(enabled={tc.enabled}, serve_format={tc.serve_format!r})")


class TernaryLinear(nn.Module):
    """Serving form of one ternary linear for a logical (d_in, d_out)
    weight: ``packed`` (R, N) uint8 or ``trits`` (d_in, d_out) int8, by the
    config's serve format, and the float32 ``scale``.  ``mesh`` (a
    ``distributed.plan.Mesh``) marks a row-parallel shard, whose output is
    summed over the mesh's "model" axis."""

    def __init__(self, d_in: int, d_out: int, tc: TernaryConfig, device=None):
        super().__init__()
        check_format(tc)
        self.d_in, self.d_out, self.tc = d_in, d_out, tc
        self.mesh = None
        if tc.serve_format == "packed":
            rows = twd.packed_rows(d_in, ROW_ALIGN)
            self.register_buffer("packed", torch.zeros((rows, d_out), dtype=torch.uint8,
                                                       device=device))
        else:
            self.register_buffer("trits", torch.zeros((d_in, d_out), dtype=torch.int8,
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
    """Master {"w"} -> serving {"packed" (R, N) uint8 | "trits" (K, N) int8,
    "scale" float32}."""
    check_format(tc)
    tw = tq.ternary_quantize(p["w"])
    if tc.serve_format == "packed":
        return {"packed": twd.pack_ternary(tw.values, row_align=ROW_ALIGN),
                "scale": tw.scale}
    return {"trits": tw.values, "scale": tw.scale}


def shard_tlin(lin: TernaryLinear, axis: int, lo: int, hi: int, device=None) -> dict:
    """The serving leaves of ``lin``'s logical weight cut to ``[lo, hi)``
    along ``axis`` (0: K, a row-parallel shard; 1: N, a column-parallel
    one), on ``device`` (default lin's).  An N cut of a packed slab is a
    slice (bytes pack along K); a K cut is decoded to trits, sliced and
    packed again with its rows padded to ROW_ALIGN, which is exact (packing
    is lossless) where a slice of the slab would split bytes.  The scale is
    the whole weight's."""
    key = "packed" if lin.tc.serve_format == "packed" else "trits"
    w = getattr(lin, key).to(device)
    if axis == 1:
        cut = w[:, lo:hi]
    elif key == "trits":
        cut = w[lo:hi]
    else:
        cut = twd.pack_ternary(twd.unpack_ternary(w, lin.d_in)[lo:hi], row_align=ROW_ALIGN)
    return {key: cut.contiguous(), "scale": lin.scale.to(device, copy=True)}


def tlin_compact(x: torch.Tensor, tc: TernaryConfig,
                 norm_scale: torch.Tensor | None = None) -> ops.DasTopK | None:
    """The DAS step of x's flattened rows, of ``rmsnorm(norm_scale, x)``
    when a norm scale is given, or None with DAS off.  The kernel takes the
    scale in x's dtype: a bfloat16 scale over a float32 stream (the
    stub-frontend models) is upcast, which is exact and is what ``rmsnorm``
    computes with."""
    if tc.das is None:
        return None
    if norm_scale is not None:
        norm_scale = norm_scale.to(x.dtype)
    # a tuned native dense impl takes the masked dense rows: the same pass writes them
    dispatch = ops.current_dispatch()
    dense = (dispatch.mode == "tuned" and tc.serve_format == "packed"
             and autotune.takes_dense(device=x.device, cache=dispatch.cache,
                                      m=x.numel() // x.shape[-1], k=x.shape[-1],
                                      keep=tc.das.keep, block=tc.das.block, dtype=x.dtype))
    return ops.das_topk(x, keep=tc.das.keep, block=tc.das.block,
                        norm_scale=norm_scale, with_mask=False, with_dense=dense)


def tlin_norm_input(x: torch.Tensor, norm_scale: torch.Tensor, tc: TernaryConfig):
    """What projections fed by ``rmsnorm(norm_scale, x)`` take, as (input,
    shared DAS step): with DAS on, x itself (``tlin_apply`` reads only its
    shape and dtype) and the DAS step with the norm inside it; with DAS off,
    the normed x and None."""
    if tc.das is None:
        return rmsnorm(norm_scale, x), None
    return x, tlin_compact(x, tc, norm_scale)


def tlin_apply(lin: TernaryLinear, x: torch.Tensor,
               ca: ops.DasTopK | None = None) -> torch.Tensor:
    """x (..., K) -> (..., N) in x's dtype; ``ca`` is a shared DAS step of x
    (given one, x is read for its shape and dtype only)."""
    k = x.shape[-1]
    lead = x.shape[:-1]
    if lin.tc.das is not None and ca is None:
        ca = tlin_compact(x, lin.tc)
    if lin.tc.serve_format == "packed":
        tuned = ops.current_dispatch().mode == "tuned"
        gemm = autotune.run_gemm if tuned else ops.ternary_gemm
        if ca is None:
            y = gemm(x.reshape(-1, k).contiguous(), lin.packed, lin.scale)
        elif ca.values is not None and tuned:
            y = autotune.run_das_gemm(ca.values, ca.indices, lin.packed, lin.scale,
                                      keep=lin.tc.das.keep, block=lin.tc.das.block,
                                      dense=ca.dense)
        elif ca.values is not None:
            y = ops.das_ternary_gemm(ca.values, ca.indices, lin.packed, lin.scale,
                                     keep=lin.tc.das.keep, block=lin.tc.das.block)
        else:
            y = gemm(ca.dense, lin.packed, lin.scale)
    else:
        scale = lin.scale if x.dtype == torch.float32 else lin.scale.to(x.dtype).float()
        if ca is None:
            y = ops.das_gemv(x.reshape(-1, k).contiguous(), None, lin.trits, scale)
        elif ca.values is not None:
            y = ops.das_gemv(ca.values, ca.indices, lin.trits, scale,
                             keep=lin.tc.das.keep, block=lin.tc.das.block)
        else:
            y = ops.das_gemv(ca.dense, None, lin.trits, scale)
    if lin.mesh is not None:
        y = collectives.psum(y, lin.mesh, "model")
    return y.reshape(*lead, y.shape[-1]).to(x.dtype)


def das_train_mask(x: torch.Tensor, tc: TernaryConfig) -> torch.Tensor:
    """The DAS keep-mask of x (..., K), int8 0/1, outside autograd."""
    step = ops.das_topk(x.detach(), keep=tc.das.keep, block=tc.das.block, with_compact=False)
    return step.mask.reshape(x.shape)


@torch.no_grad()
def shard_scales(p: dict, mesh) -> dict:
    """The master tree ``p`` of a rank's shard with {"w", "gamma"} for every
    ternary linear that the "model" axis cuts: gamma the whole weight's
    absmean scale, (sum of |W| over the ranks) / (their count) + eps in W's
    dtype, from one float32 all-reduce for the whole tree (a cut that
    several ranks hold, a replicated kv head, adds to both sums alike).  An
    expert stack keeps its own scale an expert, whole on its rank."""
    named = [(name[:-2], w) for name, w in tree_leaves(p).items()
             if name.endswith(".w") and "model" in leaf_spec(name, w.ndim)
             and not name.rsplit(".", 2)[-2].startswith("experts_")]
    if not named or mesh.size("model") == 1:
        return p
    dev = named[0][1].device
    sums = torch.stack([torch.stack([w.abs().sum(dtype=torch.float32) for _, w in named]),
                        torch.tensor([float(w.numel()) for _, w in named], device=dev)], 1)
    sums = collectives.psum(sums, mesh, "model")
    gammas = {name: (s / n).to(w.dtype) + tq.EPS for (name, w), (s, n) in zip(named, sums)}

    def walk(tree, prefix):
        if isinstance(tree, dict):
            out = {k: walk(v, f"{prefix}{k}.") for k, v in tree.items()}
            if prefix[:-1] in gammas:
                out["gamma"] = gammas[prefix[:-1]]
            return out
        if isinstance(tree, (tuple, list)):
            return type(tree)(walk(v, f"{prefix}{i}.") for i, v in enumerate(tree))
        return tree
    return walk(p, "")


def tlin_train_input(x: torch.Tensor, tc: TernaryConfig, mesh=None) -> torch.Tensor:
    """What the master projections of x multiply: x DAS-masked (with DAS
    on) and int8 fake-quantized; x itself with the ternary stack off.  With
    ``mesh``, x is a row-parallel input cut over "model": its int8 scale is
    the row's absmax over "model"."""
    if not tc.enabled:
        return x
    if tc.das is not None:
        x = das_lib.das_apply(x, das_train_mask(x, tc))
    if mesh is None or mesh.size("model") == 1:
        return tq.int8_fake_quant(x)
    amax = x.detach().abs().amax(dim=-1, keepdim=True).float()
    return tq.int8_fake_quant(x, collectives.pmax(amax, mesh, "model").to(x.dtype))


def tlin_train(p: dict, xq: torch.Tensor, tc: TernaryConfig, *,
               partial: bool = False) -> torch.Tensor:
    """xq (..., K) from ``tlin_train_input`` times the STE ternary
    fake-quant of the master weight p["w"] (K, N) (at p["gamma"], a shard's
    whole-weight scale, where ``shard_scales`` put one), in xq's dtype; with
    the ternary stack off, times the weight itself.  ``partial``: a
    row-parallel shard's product, returned in float32 for the caller's sum
    over "model"."""
    if not tc.enabled:
        w = p["w"] if "w" in p else p["w_hp"]
    else:
        w = tq.ternary_fake_quant(p["w"], p.get("gamma"))
    if partial:
        return torch.matmul(xq.float(), w.float())
    return torch.matmul(xq, w.to(xq.dtype))
