"""Elastic scaling: the mesh that survives a device loss.

The JAX package's ``distributed/elastic.py``: ``plan_remesh`` picks the
largest (data, model) mesh for a surviving device count, keeping the model
axis (the tensor-parallel degree, a constraint of fit) and halving it only
while it does not divide the survivors; the data axis is free to shrink.
``elastic_restore`` (a checkpoint restored onto a mesh) waits for the
training half of the distributed slice (ROADMAP queue 1, item 2).
"""

from __future__ import annotations

__all__ = ["plan_remesh"]


def plan_remesh(n_devices: int, *, model: int = 16,
                axis_names=("data", "model")) -> tuple[tuple[int, int], tuple]:
    """Largest (data, model) mesh fitting n_devices, preserving TP degree."""
    while model > 1 and n_devices % model:
        model //= 2
    data = max(1, n_devices // model)
    return (data, model), axis_names
