"""The port's distributed layout against the JAX package's.

``distributed.plan.ShardingPlan``'s specs equal ``repro``'s
``ShardingPlan.for_config(cfg, topo).params`` leaf by leaf, through the
bridge's name map (``models.model.flatten_tree``), for every arch of the
registry, reduced, at Topology(1, 2), (2, 2) and (1, 4); ``validate``
raises where ``repro``'s does; the cache specs agree where the leaf names
and shapes do.  ``Topology``'s properties, ``dp_axes_for``, ``shrink`` and
``elastic.plan_remesh`` equal ``repro``'s over a grid.  The rank
boundaries (``model_bounds``) put every boundary of a DAS input on a
multiple of the DAS block with the dense tail on the last rank, and a
repacked K shard decodes to the rank's trits exactly.  ``ShardingPlan.zero1``
over the master tree's float32 moments equals ``repro``'s (the ZeRO-1 specs
of its ``train_shardings``) for every arch at (dp, tp) = (2, 1), (2, 2),
(4, 2), with the same count in its summary warning; ``bridge.load_master_
shard`` cuts each master leaf at the rank's bounds.  No devices: every
serving tree is built from shapes (``jax.eval_shape`` / the ``meta``
device), the reduced master trees on the CPU.
"""
import dataclasses
import functools
import re
import warnings

import pytest
import torch

from repro_torch.configs import ARCH_MODULES, get_config, reduced
from repro_torch.core import twd
from repro_torch.distributed import elastic
from repro_torch.distributed.plan import ShardingPlan, Topology, shard_bounds
from repro_torch.distributed.sharding import leaf_spec
from repro_torch.models import model as MD
from repro_torch.models.ternary_linear import ROW_ALIGN, TernaryLinear, shard_tlin

ARCHS = sorted(ARCH_MODULES)
TOPOLOGIES = [(1, 2), (2, 2), (1, 4)]


@functools.lru_cache(maxsize=None)
def _jax_side(arch):
    """(repro cfg, its serving tree of shapes)."""
    import jax

    from repro.configs import get_config as jget
    from repro.configs import reduced as jreduced
    from repro.models import model as JMD
    cfg = jreduced(jget(arch))
    tree = jax.eval_shape(lambda: JMD.export_serving(
        JMD.init_params(jax.random.PRNGKey(0), cfg), cfg))
    return cfg, tree


def _jax_plan(arch, topo, validate=False):
    from repro.distributed.plan import ShardingPlan as JPlan
    from repro.distributed.plan import Topology as JTopology
    cfg, _ = _jax_side(arch)
    return JPlan.for_config(cfg, JTopology(dp=topo[0], tp=topo[1]), validate=validate)


def _named(spec_tree, cfg) -> dict:
    """repro's spec tree as {port name: spec tuple}, through flatten_tree."""
    return {name: tuple(spec) for name, spec in MD.flatten_tree(spec_tree, cfg).items()}


@pytest.mark.parametrize("topo", TOPOLOGIES, ids=lambda t: f"dp{t[0]}tp{t[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_specs_match_jax(arch, topo):
    jcfg, jtree = _jax_side(arch)
    cfg = reduced(get_config(arch))
    want = _named(_jax_plan(arch, topo).params, cfg)
    plan = ShardingPlan.for_config(cfg, Topology(dp=topo[0], tp=topo[1]), validate=False)
    assert plan.params == want
    # validate raises exactly where repro's does
    try:
        _jax_plan(arch, topo, validate=True)
        jax_ok = True
    except ValueError:
        jax_ok = False
    tree = MD.TernaryLM(cfg, "meta")
    if jax_ok:
        plan.validate(tree)
    else:
        with pytest.raises(ValueError, match="does not fit this tree"):
            plan.validate(tree)
    assert len(plan.describe(tree).splitlines()) >= len(want)


@pytest.mark.parametrize("arch", ["bitnet-1.3b", "qwen3-moe-30b-a3b", "gemma2-2b"])
def test_validate_raises_where_jax_does(arch):
    cfg = reduced(get_config(arch))
    with pytest.raises(ValueError):
        _jax_plan(arch, (1, 3), validate=True)
    with pytest.raises(ValueError, match="not divisible by model=3"):
        ShardingPlan.for_config(cfg, Topology(tp=3))


@pytest.mark.parametrize("arch", ["bitnet-1.3b", "qwen3-moe-30b-a3b", "rwkv6-3b",
                                  "zamba2-2.7b", "gla-1.3b"])
@pytest.mark.parametrize("layout", ["auto", "paged"])
def test_cache_specs_match_jax(arch, layout):
    import jax
    import jax.numpy as jnp

    from repro.distributed.plan import Topology as JTopology
    from repro.models import model as JMD
    from repro.models.transformer import Runtime
    jcfg, _ = _jax_side(arch)
    cfg = reduced(get_config(arch))
    paged = dict(page_size=8, num_pages=17) if layout == "paged" else {}
    sparse = layout != "paged"
    jcaches = jax.eval_shape(lambda: JMD.init_caches(
        None, jcfg, 4, 64, Runtime(serve_sparse=sparse), jnp.float32, **paged))
    want_plan = _jax_plan(arch, (2, 2)).with_caches(jcaches, batch=4)
    want = _named({"embed": None, "final_norm": None,
                   "layers": {"stacked": None, "tail": want_plan.caches["tail"]}}, cfg)
    shapes = _named({"embed": None, "final_norm": None,
                     "layers": {"stacked": None, "tail": jax.tree.map(
                         lambda a: tuple(a.shape), jcaches["tail"])}}, cfg)
    caches = MD.init_caches(cfg, 4, 64, device="meta", serve_sparse=sparse, **paged)
    plan = ShardingPlan.for_config(cfg, Topology(dp=2, tp=2), validate=False)
    got = plan.with_caches(caches, batch=4).caches
    port_shapes = {f"layers.{i}.{k}": tuple(t.shape) for i, c in enumerate(caches)
                   for k, t in c.items()}
    common = [n for n in got if n in want and shapes[n] == port_shapes[n]]
    assert len(common) >= len(caches), sorted(got)
    for name in common:
        assert got[name] == want[name], name
    # per-slot rows ride the dp axes; a paged arena is batch-free
    assert any("data" in str(s) for s in got.values()) == (layout == "auto"
                                                           or arch in ("rwkv6-3b", "gla-1.3b",
                                                                       "zamba2-2.7b"))


def test_topology_algebra_matches_jax():
    from repro.distributed import elastic as jelastic
    from repro.distributed.plan import Topology as JTopology
    for pods in (1, 2):
        for dp in (1, 2, 3, 4):
            for tp in (1, 2, 4, 16):
                t, j = Topology(dp=dp, tp=tp, pods=pods), JTopology(dp=dp, tp=tp, pods=pods)
                assert (t.axis_names, t.shape, t.n_devices, t.dp_axes, t.dp_extent) == \
                    (j.axis_names, j.shape, j.n_devices, j.dp_axes, j.dp_extent)
                assert t.batch_spec() == tuple(j.batch_spec())
                assert t.batch_spec(sequence_sharded=True) == \
                    tuple(j.batch_spec(sequence_sharded=True))
                for a in t.axis_names:
                    assert t.axis_size(a) == j.axis_size(a)
                for n in range(0, 40):
                    assert t.model_divides(n) == j.model_divides(n)
                    assert t.dp_axes_for(n + 1) == j.dp_axes_for(n + 1)
                for n in range(1, t.n_devices + 1):
                    s, js = t.shrink(n), j.shrink(n)
                    assert (s.dp, s.tp, s.pods) == (js.dp, js.tp, js.pods)
    for n in range(0, 70):
        for m in (1, 2, 3, 4, 8, 16):
            assert elastic.plan_remesh(n, model=m) == jelastic.plan_remesh(n, model=m)
    assert Topology.production(multi_pod=True).shape == JTopology.production(
        multi_pod=True).shape
    assert Topology(dp=2, tp=2).shrink(2) == Topology(dp=1, tp=2)
    with pytest.raises(ValueError, match="must be an int >= 1"):
        Topology(tp=0)


def test_build_mesh_needs_a_world():
    with pytest.raises(RuntimeError, match="initialised torch.distributed world"):
        Topology(dp=2, tp=2).build_mesh()


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_rank_bounds_keep_das_blocks_whole(arch, tp):
    """Every boundary of a DAS input (d_ff, a shared expert's width, wo's
    q_dim) falls on a multiple of the DAS block, the dense tail on the last
    rank; heads, vocab and experts split evenly; fewer kv heads than ranks
    (gemma3-1b's one) are replicated: each rank holds the one kv head its q
    heads read, ``kv_replicas`` ranks in a row the same."""
    cfg = get_config(arch)
    bounds = MD.model_bounds(cfg, tp)
    if cfg.n_kv_heads % tp:
        r, hd = MD.kv_replicas(cfg, tp), cfg.head_dim_
        assert r == tp // cfg.n_kv_heads > 1
        assert bounds.pop("kv") == tuple((m // r * hd, (m // r + 1) * hd) for m in range(tp))
        assert MD.local_config(cfg, _RankOf(tp, 0)).n_kv_heads == 1
    block = cfg.ternary.das.block if cfg.ternary.das is not None else 1
    sizes = {"q": cfg.q_dim, "kv": cfg.kv_dim, "vocab": cfg.vocab_padded,
             "ff": cfg.d_ff, "experts": cfg.moe and cfg.moe.n_experts,
             "shared": cfg.moe and cfg.moe.d_expert * cfg.moe.n_shared}
    for key, b in bounds.items():
        assert len(b) == tp and b[0][0] == 0 and b[-1][1] == sizes[key]
        assert all(b[i][1] == b[i + 1][0] for i in range(tp - 1))
        if key in ("ff", "shared"):
            assert all(hi % block == 0 for _, hi in b[:-1]), (key, b)
            assert (b[-1][1] - b[-1][0]) % block == sizes[key] % block
        if key in ("q", "kv"):
            assert all((hi - lo) % cfg.head_dim_ == 0 for lo, hi in b)
    if arch == "bitnet-1.3b" and tp == 2:
        assert bounds["ff"] == ((0, 2720), (2720, 5460))
    assert shard_bounds(5460, 2, unit=32) == ((0, 2720), (2720, 5460))
    assert shard_bounds(10, 3) == ((0, 4), (4, 7), (7, 10))


@pytest.mark.parametrize("k,bounds", [(5460, ((0, 2720), (2720, 5460))),
                                      (128, ((0, 64), (64, 128))),
                                      (2048, ((0, 1024), (1024, 2048)))])
@pytest.mark.parametrize("fmt", ["packed", "int8"])
def test_repacked_shards_decode_to_the_rank_trits(k, bounds, fmt):
    """A K cut (row-parallel) is repacked from its trits: it decodes to the
    rank's lanes exactly, its rows padded to 16 decode to zeros; an N cut
    is a slice of the slab."""
    from repro_torch.configs.base import TernaryConfig
    tc = TernaryConfig(serve_format=fmt)
    g = torch.Generator().manual_seed(k)
    trits = torch.randint(-1, 2, (k, 24), generator=g).to(torch.int8)
    lin = TernaryLinear(k, 24, tc, "cpu")
    if fmt == "packed":
        lin.packed.copy_(twd.pack_ternary(trits, row_align=ROW_ALIGN))
    else:
        lin.trits.copy_(trits)
    for lo, hi in bounds:
        cut = shard_tlin(lin, 0, lo, hi)
        if fmt == "packed":
            rows = cut["packed"].shape[0]
            assert rows % ROW_ALIGN == 0 and rows == twd.packed_rows(hi - lo, ROW_ALIGN)
            lanes = twd.unpack_ternary(cut["packed"], 5 * rows)
            assert torch.equal(lanes[:hi - lo], trits[lo:hi])
            assert not lanes[hi - lo:].any()
        else:
            assert torch.equal(cut["trits"], trits[lo:hi])
        assert torch.equal(cut["scale"], lin.scale)
        col = shard_tlin(lin, 1, 8, 16)
        want = trits[:, 8:16] if fmt == "int8" else twd.pack_ternary(trits, ROW_ALIGN)[:, 8:16]
        assert torch.equal(col["trits" if fmt == "int8" else "packed"], want)


def test_unshardable_configs_raise():
    for arch in ("rwkv6-3b", "gla-1.3b", "zamba2-2.7b", "musicgen-medium"):
        with pytest.raises(ValueError, match="ROADMAP queue 1, item 2"):
            MD.check_shardable(reduced(get_config(arch)), 2)
    with pytest.raises(ValueError, match="n_heads=32"):
        MD.check_shardable(get_config("bitnet-1.3b"), 3)
    # 4 heads of 16 at tp 4: one head a rank would split wo's 32-lane DAS blocks
    cfg = dataclasses.replace(reduced(get_config("bitnet-1.3b")), n_kv_heads=4)
    with pytest.raises(ValueError, match="DAS block"):
        MD.check_shardable(cfg, 4)


def test_untrainable_configs_raise():
    """Training under a Topology refuses what serving does, naming ROADMAP
    queue 1, item 2; the MoE trains with its experts cut over "model":
    ``shard_params`` gives rank r of tp its experts [e0, e1) of every
    stack (and serving shards them alike)."""
    for arch in ("rwkv6-3b", "gla-1.3b", "zamba2-2.7b", "musicgen-medium"):
        with pytest.raises(ValueError, match="does not train under a Topology.*queue 1, item 2"):
            MD.check_shardable(reduced(get_config(arch)), 2, training=True)
    moe = reduced(get_config("qwen3-moe-30b-a3b"))
    full = MD.init_params(moe, device="cpu")
    n = moe.moe.n_experts
    for tp in (1, 2):
        for r in range(tp):
            shard = MD.shard_params(full, moe, _RankOf(tp, r))
            e0, e1 = r * n // tp, (r + 1) * n // tp
            assert MD.model_bounds(moe, tp)["experts"][r] == (e0, e1)
            for blk, want in zip(shard["layers"]["tail"], full["layers"]["tail"]):
                for name in ("experts_gate", "experts_in", "experts_out"):
                    assert torch.equal(blk["moe"][name]["w"], want["moe"][name]["w"][e0:e1])
                assert torch.equal(blk["moe"]["router"], want["moe"]["router"])
    MD.check_shardable(moe, 2)                    # serving shards its experts


class _RankOf:
    """A Mesh stand-in naming one model rank of tp ways (``shard_model``
    reads the topology and the index; no collective runs here)."""

    def __init__(self, tp, index):
        self.topology, self.model_index = Topology(tp=tp), index
        self.experts_only = False


@pytest.mark.parametrize("arch", ["bitnet-1.3b", "qwen3-moe-30b-a3b", "kimi-k2-1t-a32b"])
def test_bridge_carries_repro_tree_to_each_rank(arch):
    """``bridge.load_serving_shard`` of ``repro``'s serving tree: each of the
    two ranks' leaves is the full leaf's cut along the plan's axis at the
    rank's bounds (a packed K cut repacked from its trits), the rest whole."""
    import jax
    import numpy as np

    from repro.configs import get_config as jget
    from repro.configs import reduced as jreduced
    from repro.models import model as JMD
    from repro_torch.bridge import load_serving_shard, load_serving_tree
    jcfg, cfg = jreduced(jget(arch)), reduced(get_config(arch))
    tree = jax.tree.map(np.asarray, JMD.export_serving(
        JMD.init_params(jax.random.PRNGKey(0), jcfg), jcfg))
    full = load_serving_tree(tree, cfg, "cpu")
    specs = ShardingPlan.for_tree(full, Topology(tp=2)).params
    bounds = MD.model_bounds(cfg, 2)
    for r in (0, 1):
        local = load_serving_shard(tree, cfg, _RankOf(2, r), "cpu").state_dict()
        for name, want in full.state_dict().items():
            got, spec = local[name], specs[name]
            if "model" not in spec:
                assert torch.equal(got, want), name
                continue
            axis = spec.index("model")
            role = next(n for n in reversed(name.split(".")) if n in MD._ROLE)
            lo, hi = bounds[MD._ROLE[role]][r]
            if name.endswith("packed") and axis == 0 and "experts" not in name:
                got, want = twd.unpack_ternary(got, hi - lo), twd.unpack_ternary(
                    want, 5 * want.shape[0])[lo:hi]
            else:
                want = want.narrow(axis, lo, hi - lo)
            assert torch.equal(got, want), name


ZERO_TOPOLOGIES = [(2, 1), (2, 2), (4, 2)]


def _warned(fn):
    """(fn(), the moment-leaf counts of the zero1 summary warnings it gave)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn()
    return out, [int(m.group(1)) for w in caught
                 if (m := re.match(r"zero1_specs: (\d+) moment leaves", str(w.message)))]


@pytest.mark.parametrize("topo", ZERO_TOPOLOGIES, ids=lambda t: f"dp{t[0]}tp{t[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_zero1_specs_match_jax(arch, topo):
    """The moments' ZeRO-1 specs of ``repro``'s ``train_shardings`` (its
    plan over the master tree, ``plan.zero1(opt.m)``) leaf by leaf, and the
    summary warning's count of the leaves that stay unsharded."""
    import jax
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_config as jget
    from repro.configs import reduced as jreduced
    from repro.distributed.plan import ShardingPlan as JPlan
    from repro.distributed.plan import Topology as JTopology
    from repro.models import model as JMD
    from repro.optim import adamw as jadamw
    from repro_torch.optim import adamw
    from repro_torch.tree import leaves
    jcfg = jreduced(jget(arch))
    shapes = jax.eval_shape(lambda: JMD.init_params(jax.random.PRNGKey(0), jcfg))
    moments = jax.eval_shape(lambda: jadamw.adamw_init(shapes)).m
    jplan = JPlan.for_tree(shapes, JTopology(dp=topo[0], tp=topo[1]), validate=False)
    want, jcount = _warned(lambda: jplan.zero1(moments))
    want = [tuple(s) for s in jax.tree.leaves(want, is_leaf=lambda x: isinstance(x, P))]
    params = MD.init_params(reduced(get_config(arch)), device="cpu")
    plan = ShardingPlan.for_tree(params, Topology(dp=topo[0], tp=topo[1]), validate=False)
    got, count = _warned(lambda: plan.zero1(adamw.adamw_init(params).m))
    assert len(got) == len(leaves(params))
    assert list(got.values()) == want
    assert count == jcount
    assert any("data" in s for s in want)


def test_master_shard_cuts_each_leaf():
    """``bridge.load_master_shard`` of ``repro``'s master tree: each rank's
    leaf is the full leaf cut at the rank's bounds along the plan's "model"
    axis (d_ff on whole DAS blocks), the rest whole; floating leaves
    require grad."""
    import jax
    import numpy as np

    from repro.configs import get_config as jget
    from repro.configs import reduced as jreduced
    from repro.models import model as JMD
    from repro_torch.bridge import load_master_shard, load_master_tree
    from repro_torch.distributed.plan import tree_leaves
    cfg = dataclasses.replace(reduced(get_config("bitnet-1.3b")), d_ff=160)
    jcfg = dataclasses.replace(jreduced(jget("bitnet-1.3b")), d_ff=160)
    tree = jax.tree.map(np.asarray, JMD.init_params(jax.random.PRNGKey(0), jcfg))
    full = tree_leaves(load_master_tree(tree, cfg, "cpu"))
    bounds = MD.model_bounds(cfg, 2)
    assert bounds["ff"] == ((0, 96), (96, 160))
    for r in (0, 1):
        local = tree_leaves(load_master_shard(tree, cfg, _RankOf(2, r), "cpu"))
        assert local.keys() == full.keys()
        for name, want in full.items():
            got = local[name]
            assert got.requires_grad
            spec = leaf_spec(name, want.ndim)
            if "model" in spec:
                lo, hi = bounds[MD._role(name)][r]
                want = want.narrow(spec.index("model"), lo, hi - lo)
            assert torch.equal(got.detach(), want.detach()), name
