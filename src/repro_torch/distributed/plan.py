"""Topology, Mesh and ShardingPlan: the distributed layout of the port.

The JAX package's ``distributed/plan.py`` on explicit per-rank shards:

  * ``Topology`` — the logical mesh: (pods, dp, tp) extents, axis names,
    predicates (``model_divides``, ``dp_axes_for``), ``build_mesh`` (the
    process groups of the axes, made from an initialised
    ``torch.distributed`` world, with an actionable error when the world is
    too small) and ``shrink`` for elastic recovery (through
    ``elastic.plan_remesh``).
  * ``Mesh`` — one rank's view of a built topology: its coordinates and the
    process groups of its "model" and data axes, which the collectives
    (``distributed.collectives``) take; ``Topology.virtual_mesh`` gives one
    position's view with no process group (backend "meta"), on which the
    collectives exchange nothing.
  * ``ShardingPlan`` — the specs of a serving tree (``sharding.leaf_spec``
    over ``TernaryLM.state_dict()``'s names), resolved once, validated (each
    sharded dim must divide by its axis extent), and printable; with the
    cache rules of the JAX package's ``_cache_leaf_spec``.

The plan says *which* axis a leaf shards on; ``shard_bounds`` gives each
rank's ``[lo, hi)`` along it.  The two are kept apart because the cut need
not be even: an input of the DAS step is cut on whole DAS blocks, its
dense tail (the last ``K % 32`` lanes) on the last rank, so every rank
masks exactly the lanes one device masks (``models.model.shard_model``,
``shard_params``).  A plan resolves against a serving model or against a
training master tree (nested dicts, leaves named by their path:
``layers.tail.0.attn.wq.w``); ``ShardingPlan.zero1`` gives the ZeRO-1
specs of its optimizer moments (``sharding.zero1_specs``), whose "data"
cut is even (``data_bounds``).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch

from repro_torch.distributed import elastic
from repro_torch.distributed import sharding as _rules
from repro_torch.tree import is_leaf, leaves_with_paths

__all__ = ["Topology", "Mesh", "ShardingPlan", "shard_bounds", "data_bounds",
           "cache_leaf_spec", "tree_leaves"]


# -------------------------------------------------------------------------
# Topology
# -------------------------------------------------------------------------

@dataclass(frozen=True)
class Topology:
    """Logical device mesh: ``dp`` data-parallel x ``tp`` tensor-parallel
    ways, optionally replicated over ``pods``.  Frozen and hashable so it
    can ride inside ``ServeConfig``."""

    dp: int = 1
    tp: int = 1
    pods: int = 1

    def __post_init__(self):
        for name in ("dp", "tp", "pods"):
            v = getattr(self, name)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"Topology.{name} must be an int >= 1, got {v!r}")

    # -- shape/axes --------------------------------------------------------

    @property
    def axis_names(self) -> tuple[str, ...]:
        return ("pod", "data", "model") if self.pods > 1 else ("data", "model")

    @property
    def shape(self) -> tuple[int, ...]:
        return (self.pods, self.dp, self.tp) if self.pods > 1 else (self.dp, self.tp)

    @property
    def n_devices(self) -> int:
        return self.pods * self.dp * self.tp

    @property
    def dp_axes(self) -> tuple[str, ...]:
        return ("pod", "data") if self.pods > 1 else ("data",)

    @property
    def dp_extent(self) -> int:
        return self.pods * self.dp

    def axis_size(self, axis: str) -> int:
        return {"pod": self.pods, "data": self.dp, "model": self.tp}[axis]

    # -- predicates --------------------------------------------------------

    def model_divides(self, dim: int) -> bool:
        """Can `dim` be split over the model axis?"""
        return dim > 0 and dim % self.tp == 0

    def dp_axes_for(self, global_batch: int) -> tuple[str, ...]:
        """Data-parallel axes usable for this batch (batch 1 => replicate):
        pod then data, while the batch stays divisible."""
        dp = 1
        out = []
        for a in self.dp_axes:
            if global_batch % (dp * self.axis_size(a)) == 0:
                out.append(a)
                dp *= self.axis_size(a)
        return tuple(out)

    @property
    def dp_spec(self):
        """The dp axes as one spec entry: "data", or ("pod", "data") (a
        PartitionSpec's canonical form of a one-axis tuple is the name)."""
        return self.dp_axes[0] if len(self.dp_axes) == 1 else self.dp_axes

    def batch_spec(self, *, sequence_sharded: bool = False) -> tuple:
        if sequence_sharded:
            return (None, self.dp_spec)
        return (self.dp_spec,)

    # -- mesh construction -------------------------------------------------

    def build_mesh(self, ranks=None) -> "Mesh":
        """The process groups of this topology over the first
        ``n_devices`` of ``ranks`` (default: the whole world), data-major:
        mesh position i = (data index i // tp, model index i % tp).  Every
        rank of the world must call it, in the same order (each
        ``torch.distributed.new_group`` is collective over the world); a
        rank outside the mesh gets a ``Mesh`` with ``member`` False."""
        import torch.distributed as dist
        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError(
                f"Topology{self.shape} needs an initialised torch.distributed world of "
                f"{self.n_devices} ranks; serve through the CLI (python -m "
                f"repro_torch.launch.serve --tp {self.tp} --dp {self.dp}) or "
                f"repro_torch.distributed.launch.run_ranks")
        ranks = tuple(range(dist.get_world_size()) if ranks is None else ranks)
        if len(ranks) < self.n_devices:
            raise RuntimeError(
                f"Topology{self.shape} needs {self.n_devices} ranks, the world has "
                f"{len(ranks)}: relaunch with {self.n_devices} ranks (the serve CLI "
                f"spawns dp * tp of them) or shrink --tp/--dp")
        ranks = ranks[:self.n_devices]
        tp, dp, pods = self.tp, self.dp, self.pods

        def at(p, d, m):
            return ranks[(p * dp + d) * tp + m]

        def groups(members):          # one new_group a list, on every rank alike
            return [dist.new_group(m) for m in members]

        model = groups([[at(p, d, m) for m in range(tp)]
                        for p in range(pods) for d in range(dp)])
        data = groups([[at(p, d, m) for d in range(dp)] for p in range(pods) for m in range(tp)])
        pod = groups([[at(p, d, m) for p in range(pods)] for d in range(dp) for m in range(tp)]) \
            if pods > 1 else None
        dpg = groups([[at(p, d, m) for p in range(pods) for d in range(dp)] for m in range(tp)]) \
            if pods > 1 else None
        me = dist.get_rank()
        backend = dist.get_backend()
        if me not in ranks:
            return Mesh(self, ranks, me, backend, None, None)
        i = ranks.index(me)
        p, d, m = i // (dp * tp), i // tp % dp, i % tp
        return Mesh(self, ranks, me, backend, model[p * dp + d], data[p * tp + m],
                    None if pod is None else pod[d * tp + m],
                    None if dpg is None else dpg[m])

    def virtual_mesh(self, position: int = 0) -> "Mesh":
        """The ``Mesh`` of one position of this topology with no process
        group and no world (backend "meta"): its collectives exchange
        nothing, return what the real ones return in shape and dtype, and
        are counted as the real ones are (``collectives._exchange``).  The
        dry run (``launch.dryrun``) runs a rank's step on it."""
        if not 0 <= position < self.n_devices:
            raise ValueError(f"position {position} of Topology{self.shape} "
                             f"({self.n_devices} positions)")
        return Mesh(self, tuple(range(self.n_devices)), position, "meta", None, None)

    @classmethod
    def from_mesh(cls, mesh: "Mesh") -> "Topology":
        """The topology a built mesh realises."""
        return mesh.topology

    @classmethod
    def production(cls, *, multi_pod: bool = False) -> "Topology":
        """The JAX package's 16x16 (or 2x16x16) production shape."""
        return cls(dp=16, tp=16, pods=2 if multi_pod else 1)

    # -- elastic -----------------------------------------------------------

    def shrink(self, n_devices: int) -> "Topology":
        """Topology after losing devices: keep tp if it still divides the
        survivor count (halving it otherwise, per elastic.plan_remesh) and
        fold pods into a single flat data axis.  dp never grows."""
        (data, model), _ = elastic.plan_remesh(max(1, int(n_devices)), model=self.tp)
        return dataclasses.replace(self, pods=1, dp=min(data, self.dp * self.pods),
                                   tp=model)


@dataclass(frozen=True)
class Mesh:
    """One rank's view of a built ``Topology``: the world ``ranks`` of the
    mesh (pod-, then data-major: position i = (pod, data, model) with i =
    (pod * dp + data) * tp + model), this process's world ``rank``, the
    backend, and the process groups of its axes: "model", "data" (the data
    ranks of its pod), "pod" (the same (data, model) place in every pod) and
    "dp" (pods and data together: the batch axes).  Groups are None outside
    the mesh; with one pod, "dp" is "data" and "pod" has one rank.  With
    ``experts_only`` (``experts_alone()``) the "model" axis cuts a MoE's
    experts alone and every other leaf is whole on each rank (the JAX dry
    run's ``dpattn``): what the training runtime, ``shard_params``,
    ``gather_params`` and ``zero_layout`` all read."""
    topology: Topology
    ranks: tuple
    rank: int
    backend: str
    model_group: object
    data_group: object
    pod_group: object = None
    dp_group: object = None
    experts_only: bool = False

    def experts_alone(self) -> "Mesh":
        """This mesh with "model" cutting a MoE's experts alone."""
        return dataclasses.replace(self, experts_only=True)

    @property
    def member(self) -> bool:
        return self.rank in self.ranks

    @property
    def _pos(self) -> int:
        return self.ranks.index(self.rank)

    @property
    def model_index(self) -> int:
        return self._pos % self.topology.tp

    @property
    def data_index(self) -> int:
        """The rank's index on "data", within its pod."""
        return self._pos // self.topology.tp % self.topology.dp

    @property
    def pod_index(self) -> int:
        return self._pos // (self.topology.dp * self.topology.tp)

    @property
    def dp_index(self) -> int:
        """The rank's index on "dp" (pods and data together): its batch rows."""
        return self._pos // self.topology.tp

    def index(self, axis: str) -> int:
        return {"model": self.model_index, "data": self.data_index, "pod": self.pod_index,
                "dp": self.dp_index}[axis]

    def group(self, axis: str):
        """The process group of ``axis``: "model", "data", "pod" or "dp"."""
        if axis == "dp" and self.dp_group is None:
            return self.data_group
        return {"model": self.model_group, "data": self.data_group, "pod": self.pod_group,
                "dp": self.dp_group}[axis]

    def size(self, axis: str) -> int:
        t = self.topology
        return {"model": t.tp, "data": t.dp, "pod": t.pods, "dp": t.dp_extent}[axis]

    def axis_ranks(self, axis: str) -> tuple:
        """The world ranks of this rank's ``axis`` group, in axis order."""
        t, i = self.topology, self._pos
        stride = {"model": 1, "data": t.tp, "pod": t.dp * t.tp, "dp": t.tp}[axis]
        first = i - self.index(axis) * stride
        return tuple(self.ranks[first + j * stride] for j in range(self.size(axis)))


def shard_bounds(size: int, parts: int, *, unit: int = 1) -> tuple[tuple[int, int], ...]:
    """Each of ``parts`` ranks' ``[lo, hi)`` along an axis of ``size``: the
    whole ``unit``-lane groups split as evenly as possible (the first
    ``groups % parts`` ranks one more), and the ``size % unit`` lanes left
    over on the last rank.  A DAS input takes unit = the DAS block, so no
    block straddles two ranks and the dense tail stays last (bitnet-1.3b's
    d_ff 5460 at tp 2: 2720 / 2740); heads take unit = the head size."""
    groups, tail = divmod(size, unit)
    if parts < 1 or groups < parts:
        raise ValueError(f"an axis of {size} ({groups} groups of {unit}) does not split "
                         f"over {parts} ranks")
    base, extra = divmod(groups, parts)
    out, lo = [], 0
    for r in range(parts):
        hi = lo + (base + (r < extra)) * unit + (tail if r == parts - 1 else 0)
        out.append((lo, hi))
        lo = hi
    return tuple(out)


# -------------------------------------------------------------------------
# cache specs (serving KV / recurrent state, batch-wise + head-wise)
# -------------------------------------------------------------------------

def cache_leaf_spec(name: str, shape: tuple, topo: Topology, batch: int) -> tuple:
    """Spec of one serving-cache leaf, keyed on its name (``k``, ``v``,
    ``pos``, ``k_pages``, ..., ``conv``, ``ssm``, ``wkv``, ``s``): the
    slot dim shards over the dp axes when it equals ``batch`` and divides,
    head-ish dims over "model" when they divide (``_cache_leaf_spec``)."""
    core = tuple(shape)
    nd = len(core)
    tp = topo.tp
    dp = (topo.dp_spec if topo.dp_extent > 1 and nd >= 1 and core[0] == batch
          and batch % topo.dp_extent == 0 else None)

    def out(parts) -> tuple:
        return tuple(list(parts)[:nd] + [None] * (nd - len(parts)))

    if name == "pos_pages":
        return out([None] * nd)
    if name in ("k_pages", "v_pages") and nd == 4:
        return out([None, None, "model" if tp > 1 and core[2] % tp == 0 else None, None])
    if name in ("k", "v") and nd == 4:
        for i in (2, 3):
            if tp > 1 and core[i] % tp == 0:
                parts = [dp, None, None, None]
                parts[i] = "model"
                return out(parts)
        return out([dp, None, None, None])
    if name == "conv" and nd == 3:
        return out([dp, None, "model" if tp > 1 and core[2] % tp == 0 else None])
    if name in ("ssm", "wkv", "s") and nd == 4:
        parts = [dp, None, None, None]
        for i in (1, 2, 3):
            if tp > 1 and core[i] % tp == 0:
                parts[i] = "model"
                break
        return out(parts)
    # pos tables, shift buffers, ssd token buffers, page tables: batch-wise
    return out([dp] + [None] * (nd - 1))


# -------------------------------------------------------------------------
# ShardingPlan
# -------------------------------------------------------------------------

def tree_leaves(tree) -> dict:
    """{name: leaf} of a master tree (or a moment tree of its structure),
    each leaf named by its path joined with "." (``layers.tail.0.attn.wq.w``,
    ``layers.stacked.1.ffn.w_in.w``)."""
    return {path.replace("/", "."): x for path, x in leaves_with_paths(tree)}


def _leaves(tree) -> dict:
    """{name: tensor} of a TernaryLM (its state_dict), of a {name: tensor}
    dict, or of a nested master tree (``tree_leaves``)."""
    if isinstance(tree, torch.nn.Module):
        return tree.state_dict()
    if isinstance(tree, dict) and all(is_leaf(v) for v in tree.values()):
        return tree
    return tree_leaves(tree)


def _shapes(tree) -> dict:
    return {name: tuple(t.shape) for name, t in _leaves(tree).items()}


def data_bounds(size: int, parts: int, index: int) -> tuple[int, int]:
    """Rank ``index``'s ``[lo, hi)`` of a ZeRO-1 "data" cut: ``size`` / parts
    rows each (zero1 picks only dims the data extent divides)."""
    if size % parts:
        raise ValueError(f"a ZeRO-1 cut of {size} over {parts} ranks")
    n = size // parts
    return index * n, (index + 1) * n


@dataclass(frozen=True)
class ShardingPlan:
    """The specs of one (topology, serving or master tree[, caches]) triple,
    resolved once: ``params`` and ``caches`` map a leaf's name to its spec
    tuple."""

    topology: Topology
    params: dict                # name -> spec tuple
    batch: tuple                # (B, ...) activation spec
    caches: dict | None = None  # "layers.i.key" -> spec tuple
    cfg: object = None          # the model config, where cuts need its bounds

    # -- constructors ------------------------------------------------------

    @classmethod
    def for_tree(cls, tree, topology: Topology | None = None, *,
                 validate: bool = True, cfg=None) -> "ShardingPlan":
        """Resolve specs against a serving model (or its state dict; packed
        slabs inherit the master spec) or a master tree; ``cfg`` (kept) lets
        ``elastic.shard_state`` cut by the model's bounds."""
        topo = topology or Topology()
        specs = {name: _rules.leaf_spec(name, len(shape))
                 for name, shape in _shapes(tree).items()}
        plan = cls(topology=topo, params=specs, batch=topo.batch_spec(), cfg=cfg)
        if validate:
            plan.validate(tree)
        return plan

    @classmethod
    def for_config(cls, cfg, topology: Topology | None = None, *,
                   validate: bool = True) -> "ShardingPlan":
        """Resolve specs for a model config without materialising weights:
        the serving model is built on the ``meta`` device."""
        from repro_torch.models.model import TernaryLM
        return cls.for_tree(TernaryLM(cfg, "meta"), topology, validate=validate, cfg=cfg)

    def with_caches(self, caches: list, *, batch: int) -> "ShardingPlan":
        """Attach the specs of a cache list (one dict a layer) as
        ``layers.i.key``.  ``batch`` is the slot count: the dp axes apply only
        to dims that equal it and divide by the dp extent."""
        specs = {f"layers.{i}.{key}": cache_leaf_spec(key, tuple(t.shape), self.topology, batch)
                 for i, layer in enumerate(caches) for key, t in layer.items()}
        return dataclasses.replace(self, caches=specs)

    def zero1(self, shapes, *, data_axis: str = "data", base: dict | None = None) -> dict:
        """The optimizer moments' specs: the params' specs (or ``base``'s)
        with ``data_axis`` in the first unsharded dim its extent divides,
        and the once-a-tree summary warning of the leaves that stay
        unsharded (``sharding.zero1_specs``).  ``shapes``: the moment tree
        (its shapes, and its dtype for the warning's bytes)."""
        return _rules.zero1_specs(self.params if base is None else base, _leaves(shapes),
                                  self.topology.axis_size(data_axis), data_axis)

    # -- validation / inspection ------------------------------------------

    def _iter_spec_leaves(self, tree):
        shapes = _shapes(tree)
        if set(shapes) != set(self.params):
            raise ValueError(f"plan/tree structure mismatch: {len(self.params)} specs vs "
                             f"{len(shapes)} leaves — re-resolve the plan for this tree")
        for name, spec in self.params.items():
            yield name, spec, shapes[name]

    def validate(self, tree) -> "ShardingPlan":
        """Check every sharded dim divides its axis extent; raise with a
        per-leaf report otherwise.  Returns self for chaining."""
        bad = []
        for name, spec, shape in self._iter_spec_leaves(tree):
            for i, axes in enumerate(spec):
                if axes is None:
                    continue
                axes = (axes,) if isinstance(axes, str) else tuple(axes)
                ext = math.prod(self.topology.axis_size(a) for a in axes)
                if i >= len(shape) or shape[i] % ext != 0:
                    bad.append(f"  {name}: shape {shape} dim {i} not divisible by "
                               f"{'*'.join(axes)}={ext} (spec {spec})")
        if bad:
            raise ValueError("ShardingPlan does not fit this tree on "
                             f"Topology{self.topology.shape}:\n" + "\n".join(bad))
        return self

    def replicated_leaves(self, tree, min_ndim: int = 2) -> list[str]:
        """Names of >= min_ndim-D leaves whose spec is fully replicated: the
        fall-through set that tests pin so rule gaps are loud."""
        return [name for name, spec, shape in self._iter_spec_leaves(tree)
                if len(shape) >= min_ndim and all(a is None for a in spec)]

    def describe(self, tree=None) -> str:
        """Human-readable table of the resolved layout."""
        topo = self.topology
        lines = [f"Topology(pods={topo.pods}, dp={topo.dp}, tp={topo.tp}) "
                 f"axes={topo.axis_names} shape={topo.shape}",
                 f"batch spec: {self.batch}"]
        if tree is not None:
            for name, spec, shape in self._iter_spec_leaves(tree):
                lines.append(f"  {name:48s} {str(shape):24s} {spec}")
        else:
            lines += [f"  {name:48s} {spec}" for name, spec in self.params.items()]
        if self.caches is not None:
            lines.append("cache specs:")
            lines += [f"  {name:48s} {spec}" for name, spec in self.caches.items()]
        return "\n".join(lines)
