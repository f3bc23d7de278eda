"""The serving collectives of the port: a sum over a mesh axis, and the
gather of a shard into the full tensor on every rank of the axis.

Both are ``torch.distributed.all_reduce`` sums in float32 over a
``plan.Mesh`` axis's process group ("model" or "data"); a group of
one rank returns its input.  The gather writes the shard into a
zero-filled buffer of the full shape and sums it: exact, since every
element has one contributor and x + 0 = x.  All-reduce results are the same
bits on every rank of the group, so ranks that sample from gathered logits
sample the same tokens.

One backend rule, never a switch at run time: under NCCL a CUDA tensor is
reduced where it lies; under gloo a CUDA tensor always goes through a host
copy (a device-to-host copy, the gloo sum over CPU tensors, a copy back),
so the ranks that share one card in ``chip_smoke.py`` exchange their
partials through the host.  A failed collective raises, which fails the
rank and the run.  The int8 exchange of the training half
(``int8_compress`` / ``compressed_psum`` / ``psum_scatter_mean``) waits for
ROADMAP queue 1, item 2.
"""

from __future__ import annotations

import time

import torch

__all__ = ["counts", "reset_counts", "psum", "gather"]

# collectives issued (a step's all-reduces, the gathers among them) and the
# host seconds they took: what PERF.md's "Collectives" row reads
counts = {"all_reduce": 0, "gather": 0, "seconds": 0.0, "wait_seconds": 0.0}


def reset_counts() -> None:
    counts.update(all_reduce=0, gather=0, seconds=0.0, wait_seconds=0.0)


def _all_reduce(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    import torch.distributed as dist
    t0 = time.perf_counter()
    if x.dtype != torch.float32:
        raise ValueError(f"the port's collectives sum float32, got {x.dtype}")
    group = mesh.group(axis)
    if mesh.backend == "gloo" and x.is_cuda:
        host = x.cpu()                   # waits for the kernels that wrote x
        counts["wait_seconds"] += time.perf_counter() - t0
        dist.all_reduce(host, group=group)
        x.copy_(host)
    else:
        dist.all_reduce(x, group=group)
    counts["all_reduce"] += 1
    counts["seconds"] += time.perf_counter() - t0
    return x


def psum(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """The float32 sum of x over the ranks of ``axis`` (x is left as it
    is; a new tensor is returned).  Under gloo a CUDA tensor goes through
    the host."""
    if mesh.size(axis) == 1:
        return x
    return _all_reduce(x.clone(), mesh, axis)


def gather(local: torch.Tensor, mesh, axis: str, dim: int, lo: int,
           size: int) -> torch.Tensor:
    """The full float32 tensor of size ``size`` along ``dim`` on every rank
    of ``axis``, from each rank's shard ``local`` at ``[lo, lo + n)``: the
    sum of the shards written into zeros (exact).  Under gloo a CUDA tensor
    goes through the host."""
    if mesh.size(axis) == 1 and local.shape[dim] == size:
        return local
    shape = list(local.shape)
    shape[dim] = size
    full = torch.zeros(shape, dtype=torch.float32, device=local.device)
    full.narrow(dim, lo, local.shape[dim]).copy_(local)
    counts["gather"] += 1
    return _all_reduce(full, mesh, axis)
