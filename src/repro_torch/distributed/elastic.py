"""Elastic scaling: the mesh that survives a device loss, and a training
state restored onto any mesh.

The JAX package's ``distributed/elastic.py``: ``plan_remesh`` picks the
largest (data, model) mesh for a surviving device count, keeping the model
axis (the tensor-parallel degree, a constraint of fit) and halving it only
while it does not divide the survivors; the data axis is free to shrink.
Checkpoints hold the global tree, so growing or shrinking a training job is
a restore that cuts each rank's shard (``elastic_restore``, which is
``checkpoint.restore_checkpoint(..., mesh=, plan=)``): ``shard_state`` cuts
a global {"params", "opt"} to a rank's params (``models.model.
shard_params``) and its ZeRO-1 moments (``zero_layout``: the slices
``ShardingPlan.zero1`` gives along "data").
"""

from __future__ import annotations

import torch

from repro_torch.tree import leaves, tree_map

__all__ = ["plan_remesh", "zero_layout", "shard_state", "elastic_restore"]


def plan_remesh(n_devices: int, *, model: int = 16,
                axis_names=("data", "model")) -> tuple[tuple[int, int], tuple]:
    """Largest (data, model) mesh fitting n_devices, preserving TP degree."""
    while model > 1 and n_devices % model:
        model //= 2
    data = max(1, n_devices // model)
    return (data, model), axis_names


def zero_layout(params, mesh, cfg=None):
    """The ``optim.adamw.ZeroLayout`` of a master tree (global, or a rank's
    model shard: zero1 cuts only dims "model" leaves whole) on ``mesh``:
    each leaf's ZeRO-1 "data" dim (``ShardingPlan.zero1`` over its float32
    moments, with its summary warning), whether "model" cuts it (on a mesh
    with ``experts_only`` the expert stacks alone), and with ``cfg`` how many
    ranks of "model" hold its cut (a replicated kv head's wk / wv:
    ``models.model.kv_replicas``)."""
    from repro_torch.distributed.plan import ShardingPlan
    from repro_torch.optim.adamw import ZeroLayout
    plan = ShardingPlan.for_tree(params, mesh.topology, validate=False)
    experts_only = mesh.experts_only
    specs = {n: s if not experts_only or ".experts_" in f".{n}" else (None,) * len(s)
             for n, s in plan.params.items()}
    moments = tree_map(lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta"),
                       params)
    zero = plan.zero1(moments, base=specs)
    r = 1
    if cfg is not None and not experts_only:
        from repro_torch.models.model import kv_replicas
        r = kv_replicas(cfg, mesh.topology.tp)
    kv = (".wk.w", ".wv.w")
    return ZeroLayout(mesh, tuple(z.index("data") if "data" in z else None
                                  for z in zero.values()),
                      tuple("model" in s for s in specs.values()),
                      tuple(r if n.endswith(kv) else 1 for n in specs))


@torch.no_grad()
def shard_state(tree: dict, cfg, mesh, device=None):
    """A global training state {"params": master tree, "opt": AdamWState or
    None} -> (this rank's {"params", "opt"}, its ZeroLayout), on ``device``
    (default: the leaves' own): the params cut over "model" (on a mesh with
    ``experts_only`` the expert stacks alone), the moments over "model" and
    then over "data"."""
    from repro_torch.models.model import shard_params
    from repro_torch.optim.adamw import AdamWState
    params = shard_params(tree["params"], cfg, mesh, device)
    zero = zero_layout(params, mesh, cfg)
    opt = tree.get("opt")
    if opt is not None:
        def moments(t):
            own = zero.cut(shard_params(t, cfg, mesh))
            return tree_map(lambda x: x.to(device=x.device if device is None else device,
                                           copy=True, memory_format=torch.contiguous_format),
                            own)
        step = opt.step.to(leaves(params)[0].device, copy=True)
        opt = AdamWState(step=step, m=moments(opt.m), v=moments(opt.v))
    return {"params": params, "opt": opt}, zero


def elastic_restore(directory: str, mesh, plan, step: int | None = None, *, device=None):
    """The resharding restore onto ``mesh`` (the elastic entry point): the
    global {"params", "opt"} of the checkpoint's step (default: the latest)
    cut to this rank's shard -> (tree, step).  ``plan`` is a
    ``ShardingPlan`` with its ``cfg`` (``ShardingPlan.for_tree(params,
    topology, cfg=cfg)``)."""
    from repro_torch.checkpoint.ckpt import restore_checkpoint
    return restore_checkpoint(directory, step, device=device, mesh=mesh, plan=plan)
