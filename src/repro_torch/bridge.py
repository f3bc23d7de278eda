"""Load the JAX package's serving weights into a TernaryLM, and its master
weights and optimizer state into the port's training trees.

The input is the tree that the JAX package's ``export_serving`` returns,
with every leaf converted to a numpy array: dict/tuple nesting,
``{stacked, tail, shared}`` layers (stacked leaves carry a leading group
axis), ternary linears as packed ``uint8`` or ``trits`` ``int8`` (the
"int8" and "bf16" serve formats) + float32 ``scale``, and a MoE block's
``moe`` subtree: the ``router`` in the model's dtype and the expert stacks,
packed (E, R, N) or trits (E, K, N) + per-expert ``scale`` (E, 1, 1).  bfloat16
leaves (numpy dtype named "bfloat16") are reinterpreted bit for bit.  This
is how the tests run both packages on the same weights; the port itself
never imports the JAX package.

``load_serving_shard`` carries the same tree to one rank's local model
under a Topology: the full tree through ``load_serving_tree`` on the CPU
(the host copy), then ``models.model.shard_model``'s cut.

``load_master_tree`` takes the JAX package's ``init_params`` tree (numpy
leaves, the same nesting; scan-stacked groups kept stacked, as
``transformer.stack_train`` runs them) to tensors on a device with
``requires_grad`` set, or its ``AdamWState`` (a NamedTuple of step, m and v)
to the port's.  ``load_master_shard`` carries that tree to one rank's
shard under a Topology (``models.model.shard_params``), so every rank
starts from the JAX package's weights.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import TernaryLM, shard_model, shard_params
from repro_torch.optim.adamw import AdamWState
from repro_torch.tree import leaves, tree_map

__all__ = ["to_torch", "load_serving_tree", "load_serving_shard", "load_master_tree",
           "load_master_shard"]


def to_torch(a: np.ndarray) -> torch.Tensor:
    """A numpy array as a CPU tensor of the same dtype (bfloat16 included)."""
    a = np.array(a, order="C")       # a writable copy; keeps 0-d shapes
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def load_serving_tree(tree: dict, cfg: ModelConfig, device=None) -> TernaryLM:
    """The numpy serving tree as a TernaryLM on ``device`` (CUDA unless "cpu")."""
    return TernaryLM.from_tree(tree_map(to_torch, tree), cfg, device)


def load_serving_shard(tree: dict, cfg: ModelConfig, mesh, device=None) -> TernaryLM:
    """The numpy serving tree cut to the shard of ``mesh``'s rank (a
    ``distributed.plan.Mesh``), on ``device`` (CUDA unless "cpu")."""
    return shard_model(load_serving_tree(tree, cfg, "cpu"), mesh, resolve_device(device))


def _on(tree, device, grad: bool):
    """A numpy tree as tensors on ``device``, floating ones requiring grad
    when ``grad``."""
    def leaf(a):
        t = to_torch(a).to(device)
        return t.requires_grad_() if grad and t.is_floating_point() else t
    return tree_map(leaf, tree)


def load_master_tree(tree, cfg: ModelConfig, device=None):
    """The JAX package's master params (numpy leaves) as tensors on
    ``device`` (CUDA unless "cpu"), floating leaves with ``requires_grad``;
    or its AdamWState (fields step, m, v) as the port's, without."""
    device = resolve_device(device)
    if getattr(tree, "_fields", None) == ("step", "m", "v"):
        return AdamWState(step=_on(tree.step, device, False), m=_on(tree.m, device, False),
                          v=_on(tree.v, device, False))
    embed = tuple(np.shape(tree["embed"]))
    if embed != (cfg.vocab_padded, cfg.d_model):
        raise ValueError(f"embed {embed}: {cfg.name} wants ({cfg.vocab_padded}, {cfg.d_model})")
    lay = tree["layers"]
    stacked = lay.get("stacked")
    n = len(lay["tail"]) + (0 if stacked is None else
                            len(stacked) * np.shape(leaves(stacked[0])[0])[0])
    if n != cfg.n_layers:
        raise ValueError(f"tree holds {n} layers, {cfg.name} has {cfg.n_layers}")
    return _on(tree, device, True)


def load_master_shard(tree, cfg: ModelConfig, mesh, device=None):
    """The JAX package's master params (numpy leaves) cut to the shard of
    ``mesh``'s rank (a ``distributed.plan.Mesh``) on ``device`` (CUDA
    unless "cpu"), floating leaves with ``requires_grad``."""
    shard = shard_params(load_master_tree(tree, cfg, "cpu"), cfg, mesh, resolve_device(device))
    return tree_map(lambda t: t.requires_grad_() if t.is_floating_point() else t, shard)
