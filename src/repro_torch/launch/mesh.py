"""Production mesh construction: thin delegates over ``Topology``.

The JAX package's ``launch/mesh.py``.  Axes ("data", "model") on one pod
(16 x 16 = 256 devices), ("pod", "data", "model") across 2 pods (512).
The geometry lives in ``distributed.plan.Topology`` (``Topology.
production()``); these functions keep the JAX package's call sites and are
where launch scripts take a mesh from.  A real mesh needs an initialised
``torch.distributed`` world of that many ranks (``Topology.build_mesh``);
``position`` gives one position's virtual mesh instead (no process group,
backend "meta"), which is what the dry run (``launch.dryrun``) runs on.
"""

from __future__ import annotations

from repro_torch.distributed.plan import Topology

__all__ = ["make_production_mesh", "mesh_axes", "dp_axes_for"]


def make_production_mesh(*, multi_pod: bool = False, position: int | None = None):
    """The production topology's mesh: this rank's of the world, or with
    ``position`` that position's virtual mesh."""
    topo = Topology.production(multi_pod=multi_pod)
    return topo.build_mesh() if position is None else topo.virtual_mesh(position)


def mesh_axes(mesh) -> tuple[str, ...]:
    return tuple(mesh.topology.axis_names)


def dp_axes_for(mesh, global_batch: int) -> tuple[str, ...]:
    """Data-parallel axes usable for this batch (batch 1 => replicate)."""
    return mesh.topology.dp_axes_for(global_batch)
