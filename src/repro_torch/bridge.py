"""Load the JAX package's serving weights into a TernaryLM.

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
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import TernaryLM

__all__ = ["to_torch", "load_serving_tree"]


def to_torch(a: np.ndarray) -> torch.Tensor:
    """A numpy array as a CPU tensor of the same dtype (bfloat16 included)."""
    a = np.array(a, order="C")       # a writable copy; keeps 0-d shapes
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _convert(tree):
    if isinstance(tree, dict):
        return {k: _convert(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_convert(v) for v in tree)
    if tree is None:
        return None
    return to_torch(tree)


def load_serving_tree(tree: dict, cfg: ModelConfig, device=None) -> TernaryLM:
    """The numpy serving tree as a TernaryLM on ``device`` (CUDA unless "cpu")."""
    return TernaryLM.from_tree(_convert(tree), cfg, device)
