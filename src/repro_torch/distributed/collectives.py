"""The collectives of the port, over a ``plan.Mesh`` axis's process group
("model", "data", "pod", or "dp": the pods and data ranks together).

  * ``psum`` / ``pmax`` — float32 SUM / MAX all-reduces;
  * ``gather`` — a shard into the full tensor on every rank of the axis
    (the shard written into zeros and summed: exact, every element has one
    contributor and x + 0 = x), whatever the cut's sizes;
  * ``reduce_scatter`` — the float32 sum of (P n, ...) tensors, each rank
    keeping its n rows (ZeRO-1's gradient exchange); ``psum_scatter_mean``
    divides it by P;
  * ``all_gather`` — (n, ...) shards of any dtype (int8 on the wire for
    the compressed exchange) concatenated in rank order;
  * ``send`` / ``recv`` — point to point between two ranks of an axis (the
    pipeline's activation hop);
  * ``int8_compress`` / ``int8_decompress`` / ``compressed_psum`` — the
    JAX package's int8 exchange with error feedback: each rank quantizes
    x + error to int8 with one absmax scale, the int8 values and the
    float32 scales are gathered, and every rank sums scale_p * q_p in
    float32;
  * ``sum_replicas`` — the identity forward, and backward the sum of the
    gradients of the ranks that hold one cut (a replicated kv head);
  * ``copy_to_model`` / ``reduce_from_model`` — the Megatron autograd pair:
    the identity forward and the sum over "model" backward, and the sum
    forward and the identity backward (any axis: ``reduce_from``).

A group of one rank returns its input.  All-reduce results are the same
bits on every rank of the group, so ranks that sample from gathered logits
sample the same tokens, and ranks that clip by an all-reduced norm clip by
the same factor.

One backend rule, never a switch at run time: under NCCL a CUDA tensor is
exchanged where it lies; a virtual mesh (``Topology.virtual_mesh``, backend
"meta": the dry run's one rank of a topology) exchanges nothing and returns
what the real collective returns in shape and dtype; under gloo a CUDA tensor always goes through a
host copy (a device-to-host copy, into page-locked memory from
``PINNED_BYTES`` up, the gloo collective over CPU tensors, a copy back),
so the ranks that share one card in ``chip_smoke.py`` exchange through the
host.  A failed collective raises, which fails the rank and the run.
"""

from __future__ import annotations

import time

import torch

__all__ = ["counts", "wire_bytes", "exchanging", "reset_counts", "psum", "pmax", "gather",
           "reduce_scatter", "psum_scatter_mean", "all_gather", "send", "recv", "sum_replicas",
           "int8_compress", "int8_decompress", "compressed_psum", "copy_to_model",
           "reduce_from_model", "reduce_from"]

# collectives issued (a step's all-reduces, the gathers among them, the
# reduce-scatters, all-gathers and point-to-point transfers), the bytes a
# rank put in, and the host seconds they took: what PERF.md's "Collectives"
# row reads
counts = {"all_reduce": 0, "gather": 0, "reduce_scatter": 0, "all_gather": 0, "send": 0,
          "recv": 0, "bytes": 0, "seconds": 0.0, "wait_seconds": 0.0}

# the same collectives' bytes on the wire a rank, by the JAX package's
# dry-run kinds and convention (its ``collective_bytes``): an all-reduce
# counts twice its operand (a ring's reduce-scatter and all-gather), a
# reduce-scatter its operand, an all-gather its output, a send its operand
# as a collective-permute (a receive is the other end of one)
wire_bytes = {"all-gather": 0, "all-reduce": 0, "reduce-scatter": 0, "all-to-all": 0,
              "collective-permute": 0}
_WIRE = {"all_reduce": ("all-reduce", 2), "reduce_scatter": ("reduce-scatter", 1),
         "all_gather": ("all-gather", 1), "send": ("collective-permute", 1)}


_exchanging = 0     # > 0 while an exchange runs (its own host copies and ops)


def exchanging() -> bool:
    """Whether an exchange is running: the ops dispatched now are the
    collective's own (the dry run's op counter leaves them out)."""
    return _exchanging > 0


def reset_counts() -> None:
    counts.update({k: 0.0 if isinstance(v, float) else 0 for k, v in counts.items()})
    wire_bytes.update(dict.fromkeys(wire_bytes, 0))


def _float32(x: torch.Tensor, what: str) -> None:
    if x.dtype != torch.float32:
        raise ValueError(f"the port's {what} takes float32, got {x.dtype}")


# a host copy of this many bytes or more goes through page-locked memory
PINNED_BYTES = 1 << 20


def _host(like: torch.Tensor) -> torch.Tensor:
    """A host tensor of ``like``'s shape and dtype for the gloo path: from
    PINNED_BYTES up page-locked (torch's caching host allocator), so the copy
    moves at the link's rate (a sharded training step's copies took 13–16x
    less device time a byte than through pageable memory on an H100:
    PERF.md §5); below that pageable, as a decode step's all-reduces of a
    few rows are."""
    big = like.numel() * like.element_size() >= PINNED_BYTES
    return torch.empty(like.shape, dtype=like.dtype, pin_memory=big)


def _exchange(kind: str, x, out, mesh, fn):
    """Run ``fn(x, out)``, a torch.distributed call that reads x (None for a
    receive) and writes ``out`` (x itself for an all-reduce, None for a
    send), through host copies when gloo meets a CUDA tensor; count it.
    Returns ``out``.  A virtual mesh (backend "meta": one position of a
    topology, no process group) runs no call: ``out`` keeps its shape and
    dtype and the exchange is counted as the real one is."""
    t0 = time.perf_counter()
    some = x if x is not None else out
    if kind in _WIRE:
        name, times = _WIRE[kind]
        wire = out if kind == "all_gather" else x
        wire_bytes[name] += times * wire.numel() * wire.element_size()
    global _exchanging
    _exchanging += 1
    try:
        if mesh.backend == "meta":
            pass
        elif mesh.backend == "gloo" and some.is_cuda:
            hx = None if x is None else _host(x).copy_(x)   # waits for the kernels that wrote x
            counts["wait_seconds"] += time.perf_counter() - t0
            hout = None if out is None else (hx if out is x else _host(out))
            fn(hx, hout)
            if out is not None:
                out.copy_(hout)
        else:
            fn(x, out)
    finally:
        _exchanging -= 1
    counts[kind] += 1
    counts["bytes"] += some.numel() * some.element_size()
    counts["seconds"] += time.perf_counter() - t0
    return out


def _all_reduce(x: torch.Tensor, mesh, axis: str, op=None) -> torch.Tensor:
    import torch.distributed as dist
    _float32(x, "all-reduces")
    group = mesh.group(axis)
    op = dist.ReduceOp.SUM if op is None else op
    return _exchange("all_reduce", x, x, mesh,
                     lambda a, _: dist.all_reduce(a, op=op, group=group))


def psum(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """The float32 sum of x over the ranks of ``axis`` (x is left as it
    is; a new tensor is returned)."""
    if mesh.size(axis) == 1:
        return x
    return _all_reduce(x.clone(), mesh, axis)


def pmax(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """The float32 elementwise max of x over the ranks of ``axis`` (exact)."""
    import torch.distributed as dist
    if mesh.size(axis) == 1:
        return x
    return _all_reduce(x.clone(), mesh, axis, dist.ReduceOp.MAX)


def gather(local: torch.Tensor, mesh, axis: str, dim: int, lo: int,
           size: int, *, own: bool = True) -> torch.Tensor:
    """The full float32 tensor of size ``size`` along ``dim`` on every rank
    of ``axis``, from each rank's shard ``local`` at ``[lo, lo + n)``: the
    sum of the shards written into zeros (exact).  Where several ranks hold
    one cut, all but one pass ``own=False`` and write nothing."""
    if mesh.size(axis) == 1 and local.shape[dim] == size:
        return local
    shape = list(local.shape)
    shape[dim] = size
    full = torch.zeros(shape, dtype=torch.float32, device=local.device)
    if own:
        full.narrow(dim, lo, local.shape[dim]).copy_(local)
    counts["gather"] += 1
    return _all_reduce(full, mesh, axis)


class _SumReplicas(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, lo, size):
        ctx.args = mesh, dim, lo, size
        return x

    @staticmethod
    def backward(ctx, g):
        mesh, dim, lo, size = ctx.args
        n = g.shape[dim]
        full = gather(g.float(), mesh, "model", dim, lo, size)
        return full.narrow(dim, lo, n).to(g.dtype), None, None, None, None


def sum_replicas(x: torch.Tensor, mesh, dim: int, lo: int, size: int) -> torch.Tensor:
    """x, a rank's cut [lo, lo + n) of a dim of ``size`` that other ranks of
    "model" hold too (a kv head under more ranks than kv heads): the
    identity forward; backward each rank's gradient of the cut summed over
    the ranks that hold it (written into zeros at their cuts, summed over
    "model", the rank's cut read back)."""
    if mesh is None or mesh.size("model") == 1:
        return x
    return _SumReplicas.apply(x, mesh, dim, lo, size)


def reduce_scatter(x: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """x (P n, ...) float32 on each of the P ranks of ``axis`` -> this
    rank's rows [i n, (i + 1) n) of their sum (``psum_scatter(...,
    scatter_dimension=0, tiled=True)``)."""
    import torch.distributed as dist
    _float32(x, "reduce-scatters")
    p = mesh.size(axis)
    if p == 1:
        return x
    if x.shape[0] % p:
        raise ValueError(f"reduce_scatter: {x.shape[0]} rows over {p} ranks")
    group = mesh.group(axis)
    out = torch.empty((x.shape[0] // p,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    return _exchange("reduce_scatter", x.contiguous(), out, mesh,
                     lambda a, o: dist.reduce_scatter_tensor(o, a, group=group))


def psum_scatter_mean(x: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """The reduce-scatter mean along dim 0: ``reduce_scatter`` / P."""
    return reduce_scatter(x, mesh, axis) / mesh.size(axis)


def all_gather(x: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """x (n, ...) of any dtype on each of the P ranks of ``axis`` -> (P n,
    ...), the ranks' x in rank order along dim 0 (on every rank)."""
    import torch.distributed as dist
    p = mesh.size(axis)
    if p == 1:
        return x
    group = mesh.group(axis)
    out = torch.empty((p * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return _exchange("all_gather", x.contiguous(), out, mesh,
                     lambda a, o: dist.all_gather_into_tensor(o, a, group=group))


def _peer(mesh, axis: str, index: int) -> int:
    """The world rank at ``index`` along ``axis`` from this rank."""
    return mesh.axis_ranks(axis)[index]


def send(x: torch.Tensor, mesh, axis: str, to: int) -> None:
    """Send x to the rank at index ``to`` of this rank's ``axis``."""
    import torch.distributed as dist
    peer = _peer(mesh, axis, to)
    _exchange("send", x.contiguous(), None, mesh, lambda a, _: dist.send(a, dst=peer))


def recv(like: torch.Tensor, mesh, axis: str, frm: int) -> torch.Tensor:
    """A tensor of ``like``'s shape, dtype and device received from the
    rank at index ``frm`` of this rank's ``axis``."""
    import torch.distributed as dist
    peer = _peer(mesh, axis, frm)
    out = torch.empty_like(like, memory_format=torch.contiguous_format)
    return _exchange("recv", None, out, mesh, lambda _, o: dist.recv(o, src=peer))


# --------------------------------------------------------------------------
# the int8 exchange (the JAX package's ``distributed/collectives.py``)
# --------------------------------------------------------------------------

def int8_compress(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (q int8, scale float32 scalar) with absmax scaling: scale =
    (max |x| + 1e-12) / 127, q = clip(round(x / scale), -127, 127)."""
    amax = x.abs().max() + 1e-12
    scale = (amax / 127.0).to(torch.float32)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return q.to(dtype) * scale.to(dtype)


def compressed_psum(x: torch.Tensor, mesh, axis: str,
                    error: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The int8-compressed sum of x over ``axis`` with error feedback ->
    (sum in x's dtype, new error): each rank quantizes x + error to int8,
    the int8 values and the scales are all-gathered (int8 on the wire), and
    every rank sums scale_p * q_p in float32; the new error is what the
    quantization left of x + error."""
    target = x + error
    q, scale = int8_compress(target)
    new_error = target - int8_decompress(q, scale, x.dtype)
    qg = all_gather(q[None], mesh, axis)                    # (P, ...) int8
    sg = all_gather(scale.reshape(1), mesh, axis)           # (P,) float32
    summed = torch.tensordot(sg.float(), qg.float(), dims=1)
    return summed.to(x.dtype), new_error


# --------------------------------------------------------------------------
# the Megatron pair
# --------------------------------------------------------------------------

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x

    @staticmethod
    def backward(ctx, g):
        return psum(g.float(), ctx.mesh, ctx.axis).to(g.dtype), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return psum(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """x, replicated over "model", as the input of column-parallel shards:
    the identity forward; backward the sum of the ranks' gradients over
    "model" (each shard's product gave a part of x's gradient)."""
    if mesh is None or mesh.size("model") == 1:
        return x
    return _CopyTo.apply(x, mesh, "model")


def reduce_from(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The float32 sum of the ranks' x over ``axis``, forward; backward the
    identity, for a sum whose result every rank of the axis then uses alike
    (so each rank's gradient of the sum is already the whole one)."""
    if mesh is None or mesh.size(axis) == 1:
        return x
    return _ReduceFrom.apply(x, mesh, axis)


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """The row-parallel shards' float32 partials summed over "model"
    (``reduce_from(x, mesh, "model")``)."""
    return reduce_from(x, mesh, "model")
