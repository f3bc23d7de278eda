"""Checkpoints of training trees: an npz payload, a JSON manifest, async save.

Layout (the JAX package's, with the port's own manifest):

  <dir>/step_<N>/payload.npz     leaf_i: the i-th leaf in jax.tree order
  <dir>/step_<N>/manifest.json   the tree's structure, each leaf's path,
                                 shape and dtype, the step
  <dir>/step_<N>/DONE            commit marker

A step is written to ``step_<N>.tmp`` and renamed once complete, so a crash
leaves no half-written step that ``latest_step`` would take.  bfloat16
leaves are stored as their uint16 bits and marked "bfloat16" in the
manifest.  ``async_save`` hands the write to a daemon thread after the
leaves are copied to the host; ``wait_pending`` joins it (and raises what it
raised), as every save and restore does first.

Checkpoints hold the global tree, as the JAX package's do: a sharded
trainer gathers its state before saving (``launch.train.gather_state``),
and ``restore_checkpoint(..., mesh=, plan=)`` restores the global arrays on
the host and cuts this rank's shard of {"params", "opt"}, ZeRO-1 moments
included (``distributed.elastic.shard_state``), so a step saved at one
topology restores at another.

``restore_repro_checkpoint`` reads a step written by the JAX package's
``save_checkpoint`` from its ``payload.npz`` alone: leaf_i is the i-th leaf
of a tree of the same structure given as ``like``, in ``jax.tree.flatten``'s
order (tree.py), and a bfloat16 leaf, saved by numpy as 2-byte void
("|V2"), is read back bit for bit.  Its ``manifest.pkl`` pickles a JAX
treedef and is never opened.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.optim.adamw import AdamWState
from repro_torch.tree import is_leaf, leaves, leaves_with_paths, unflatten

__all__ = ["save_checkpoint", "restore_checkpoint", "restore_repro_checkpoint",
           "latest_step", "wait_pending"]

_PENDING: list[threading.Thread] = []
_FAILED: list[BaseException] = []      # what an async write raised, for wait_pending
NAMED_TUPLES = {"AdamWState": AdamWState}    # what a manifest may name
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16,
           "int64": torch.int64, "int32": torch.int32, "int8": torch.int8,
           "uint8": torch.uint8, "bool": torch.bool}


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def _structure(tree):
    """The tree's containers as JSON (leaves as "L")."""
    if tree is None:
        return None
    if is_leaf(tree):
        return "L"
    if isinstance(tree, dict):
        return {"dict": {str(k): _structure(v) for k, v in tree.items()}}
    if hasattr(tree, "_fields"):
        name = type(tree).__name__
        if NAMED_TUPLES.get(name) is not type(tree):
            raise TypeError(f"a checkpoint holds no NamedTuple {name!r}")
        return {"namedtuple": name, "items": [_structure(v) for v in tree]}
    return {"tuple" if isinstance(tree, tuple) else "list": [_structure(v) for v in tree]}


def _skeleton(spec):
    """A tree of the manifest's structure with placeholder leaves."""
    if spec is None:
        return None
    if spec == "L":
        return 0
    if "dict" in spec:
        return {k: _skeleton(v) for k, v in spec["dict"].items()}
    if "namedtuple" in spec:
        return NAMED_TUPLES[spec["namedtuple"]](*(_skeleton(v) for v in spec["items"]))
    if "tuple" in spec:
        return tuple(_skeleton(v) for v in spec["tuple"])
    return [_skeleton(v) for v in spec["list"]]


def _host(x) -> tuple[np.ndarray, str]:
    """A leaf as a host array of its own to store (bfloat16 as its uint16
    bits) and its dtype's name: a device tensor's copy to the host is
    already its own, a host tensor is copied (an async save must not see
    later updates)."""
    if isinstance(x, torch.Tensor):
        own = x.device.type != "cpu"
        x = x.detach().cpu()
        name = str(x.dtype).removeprefix("torch.")
        a = x.view(torch.int16).numpy().view(np.uint16) if x.dtype == torch.bfloat16 \
            else x.numpy()
        return (a if own else a.copy()), name
    a = np.asarray(x)
    return a.copy(), a.dtype.name


def _tensor(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    # np.load gives a fresh C array of its own; anything else is copied
    # (keeping 0-d shapes), so the tensor may share its memory
    if not (a.flags.c_contiguous and a.flags.writeable and a.flags.owndata):
        a = np.array(a, order="C")
    if dtype == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _write(directory: str, step: int, arrays: list, manifest: dict) -> None:
    d = _step_dir(directory, step)
    tmp = d + ".tmp"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "payload.npz"),
             **{f"leaf_{i}": a for i, a in enumerate(arrays)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "DONE"), "w") as f:
        f.write("ok")
    if os.path.isdir(d):
        shutil.rmtree(d)
    os.rename(tmp, d)


def _write_async(*args) -> None:
    try:
        _write(*args)
    except BaseException as e:   # handed to the caller of wait_pending
        _FAILED.append(e)


def wait_pending() -> None:
    """Join every async save; raise what one of them raised."""
    while _PENDING:
        _PENDING.pop().join()
    if _FAILED:
        err = _FAILED.pop(0)
        _FAILED.clear()
        raise RuntimeError("an async checkpoint save failed") from err


def save_checkpoint(directory: str, step: int, tree: Any, *, async_save: bool = False) -> str:
    """Persist a tree of tensors (dicts, tuples, AdamWState, None).
    Returns the step directory."""
    wait_pending()
    flat = leaves_with_paths(tree)
    host = [_host(x) for _, x in flat]
    manifest = {"step": step, "structure": _structure(tree),
                "leaves": [{"path": p, "shape": list(a.shape), "dtype": dt}
                           for (p, _), (a, dt) in zip(flat, host)]}
    args = (directory, step, [a for a, _ in host], manifest)
    if async_save:
        t = threading.Thread(target=_write_async, args=args, daemon=True)
        t.start()
        _PENDING.append(t)
    else:
        _write(*args)
    return _step_dir(directory, step)


def latest_step(directory: str) -> int | None:
    """The highest committed step (a DONE marker, not a .tmp), or None."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp") and \
                os.path.exists(os.path.join(directory, name, "DONE")):
            steps.append(int(name[len("step_"):]))
    return max(steps) if steps else None


def _resolve_step(directory: str, step: int | None) -> tuple[str, int]:
    wait_pending()
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    return _step_dir(directory, step), step


def restore_checkpoint(directory: str, step: int | None = None, *,
                       device=None, mesh=None, plan=None) -> tuple[Any, int]:
    """Load the tree of the given (default: the latest committed) step onto
    ``device`` (CUDA unless "cpu") -> (tree, step).  With ``mesh`` (a
    ``distributed.plan.Mesh``) and ``plan`` (a ``ShardingPlan`` with its
    ``cfg``), the tree is a trainer's {"params", "opt"}, read on the host
    and cut to the rank's shard on ``device``."""
    device = resolve_device(device)
    d, step = _resolve_step(directory, step)
    with open(os.path.join(d, "manifest.json")) as f:
        man = json.load(f)
    host = mesh is not None
    with np.load(os.path.join(d, "payload.npz")) as payload:
        flat = [_tensor(payload[f"leaf_{i}"], leaf["dtype"], "cpu" if host else device)
                for i, leaf in enumerate(man["leaves"])]
    tree = unflatten(_skeleton(man["structure"]), flat)
    if not host:
        return tree, step
    return _shard(tree, d=d, mesh=mesh, plan=plan, device=device), step


def _shard(tree, *, d: str, mesh, plan, device):
    """A restored trainer state {"params", "opt"} cut to ``mesh``'s rank."""
    from repro_torch.distributed.elastic import shard_state
    if plan is None or plan.cfg is None or plan.topology != mesh.topology:
        raise ValueError("a restore onto a mesh needs the ShardingPlan of its topology, "
                         "with the model's cfg")
    if not isinstance(tree, dict) or set(tree) != {"params", "opt"}:
        raise ValueError(f"{d} holds no trainer state {{params, opt}}")
    return shard_state(tree, plan.cfg, mesh, device)[0]


def restore_repro_checkpoint(directory: str, like: Any, step: int | None = None, *,
                             device=None, mesh=None, plan=None) -> tuple[Any, int]:
    """Load a step written by the JAX package's ``save_checkpoint`` into a
    tree shaped as ``like`` (the same structure, e.g. {"params", "opt"} of
    the port's), each leaf checked against ``like``'s shape and dtype; with
    ``mesh`` and ``plan``, cut to the rank's shard as ``restore_checkpoint``
    does."""
    device = resolve_device(device)
    if mesh is not None:
        tree, step = restore_repro_checkpoint(directory, like, step, device="cpu")
        return _shard(tree, d=directory, mesh=mesh, plan=plan, device=device), step
    d, step = _resolve_step(directory, step)
    want = leaves(like)
    out = []
    with np.load(os.path.join(d, "payload.npz")) as payload:
        if len(payload.files) != len(want):
            raise ValueError(f"{d} holds {len(payload.files)} leaves, the tree "
                             f"{len(want)}")
        for i, w in enumerate(want):
            a = payload[f"leaf_{i}"]
            if a.dtype.kind == "V" and a.dtype.itemsize == 2:
                dtype = "bfloat16"
            else:
                dtype = a.dtype.name
            wdt = str(w.dtype).removeprefix("torch.")
            if tuple(a.shape) != tuple(w.shape) or dtype != wdt:
                raise ValueError(f"leaf_{i}: {tuple(a.shape)} {dtype}, the tree has "
                                 f"{tuple(w.shape)} {wdt}")
            out.append(_tensor(a.view(np.uint16) if dtype == "bfloat16" else a, dtype, device))
    return unflatten(like, out), step
