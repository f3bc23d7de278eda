"""Spawn a ``torch.distributed`` world of processes and run one function
on every rank.

``run_ranks(fn, world, *args)`` starts ``world`` processes with
``torch.multiprocessing`` (start method "spawn": a parent that has
initialised CUDA cannot fork), initialises each rank's process group from
a file in a fresh temporary directory (``init_method="file://..."``: no
port to pick, so parallel test workers never race for one), sets torch to
one intra-op thread (ranks share the host's cores), runs ``fn(rank,
*args)`` and returns every rank's return value in rank order.  A rank that
raises fails the call, and the other ranks are stopped; a collective waits
at most ``TIMEOUT_S`` for a peer.  ``fn`` must be importable by name (a
module-level function).  On CUDA, rank r takes device ``r %
torch.cuda.device_count()``: ranks share a card when there are more ranks
than cards, which gloo allows and NCCL refuses with its own error.
"""

from __future__ import annotations

import datetime
import pickle
import tempfile
from pathlib import Path

__all__ = ["TIMEOUT_S", "run_ranks", "rank_device"]

TIMEOUT_S = 600.0


def rank_device(rank: int, device_type: str):
    """The device of ``rank``: ``cuda:(rank % cards)``, or the CPU."""
    import torch
    if device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank % max(1, torch.cuda.device_count()))


def _entry(rank, fn, world, backend, tmp, args):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{tmp}/init", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        out = fn(rank, *args)
        with open(Path(tmp) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, *args, backend: str = "gloo") -> list:
    """``[fn(0, *args), ..., fn(world - 1, *args)]``, each run in a rank of
    a fresh ``world``-process group over ``backend``."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        mp.start_processes(_entry, args=(fn, world, backend, tmp, args),
                           nprocs=world, join=True, start_method="spawn")
        out = []
        for r in range(world):
            with open(Path(tmp) / f"rank{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out
