"""Checkpoints across topologies: the port's elastic restore.

Reduced bitnet-1.3b, float32, in one world of 4 gloo ranks on the CPU
(spawned once for the module):

  * a run at Topology(dp=2, tp=2) with ZeRO-1 takes a step and saves its
    state (``launch.train.gather_state``: the global tree, as the JAX
    package's checkpoints hold); ``elastic_restore`` onto dp 2 x tp 2 gives
    each rank its shards back bitwise, onto Topology(dp=1, tp=2) (2 ranks
    lost) shards that gather to the saved tree bitwise, and a restore
    without a mesh (one rank) is the saved tree itself; the run then goes
    on one more step at dp 1 x tp 2, within 1e-4 of the same two steps on
    one device;
  * a checkpoint written by ``repro``'s ``save_checkpoint`` (after a jitted
    step of its own, so the moments are not zeros) restored onto dp 2 x tp
    2 and dp 1 x tp 2 (``restore_repro_checkpoint(..., mesh=, plan=)``):
    each rank's shards gather to the JAX package's tree bitwise.

The ranks run this module's ``elastic_rank``; JAX and the JAX package are
imported only in the fixture.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import base as tbase
from repro_torch.configs import get_config
from repro_torch.distributed.launch import run_ranks
from repro_torch.distributed.plan import Topology

TOL = 1e-4
STEP_KW = dict(peak_lr=3e-3, warmup=1, total=4)


def _cfg():
    cfg = tbase.reduced(get_config("bitnet-1.3b"))
    return dataclasses.replace(cfg, ternary=dataclasses.replace(cfg.ternary, das=None))


def _batches():
    from repro_torch.data.pipeline import SyntheticLM
    data = SyntheticLM(vocab=512, seq_len=32, batch=4, seed=3)
    return [data.batch_at(s) for s in range(2)]


def _numpy(tree):
    from repro_torch.tree import leaves
    return [x.detach().numpy().copy() for x in leaves(tree)]


def _template(cfg):
    from repro_torch.models import model as MD
    from repro_torch.optim import adamw
    p = MD.init_params(cfg, seed=1, device="cpu")
    return {"params": p, "opt": adamw.adamw_init(p)}


def elastic_rank(rank: int, ckpt: str, repro_ckpt: str) -> dict:
    from repro_torch import checkpoint as C
    from repro_torch.distributed.elastic import elastic_restore
    from repro_torch.distributed.plan import ShardingPlan
    from repro_torch.launch import train as TR
    from repro_torch.models import model as MD
    cfg, batches, out = _cfg(), _batches(), {}
    full = MD.init_params(cfg, seed=0, device="cpu")
    big = Topology(dp=2, tp=2)
    mesh = big.build_mesh()
    sh = TR.train_shardings(mesh, full, cfg=cfg)
    step = TR.make_train_step(cfg, TR.make_runtime(mesh, 4), **STEP_KW)
    p, o, _ = step(sh.params, sh.opt, batches[0])
    state = TR.gather_state(mesh, p, o, cfg=cfg)
    if rank == 0:
        C.save_checkpoint(ckpt, 1, state)
    out["saved"] = _numpy(state)
    mine = _numpy({"params": p, "opt": o})
    torch.distributed.barrier()
    for topo in (big, Topology(dp=1, tp=2)):
        m = topo.build_mesh()
        if not m.member:
            continue
        plan = ShardingPlan.for_tree(full, topo, validate=False, cfg=cfg)
        tree, s = elastic_restore(ckpt, m, plan, device="cpu")
        if topo == big:
            out["own_back"] = all(np.array_equal(a, b) for a, b in zip(_numpy(tree), mine))
        out[f"dp{topo.dp}", s] = _numpy(TR.gather_state(m, tree["params"], tree["opt"],
                                                        cfg=cfg))
        like = _template(cfg)
        rtree, _ = C.restore_repro_checkpoint(repro_ckpt, like, device="cpu", mesh=m,
                                              plan=plan)
        out[f"repro dp{topo.dp}"] = _numpy(TR.gather_state(m, rtree["params"], rtree["opt"],
                                                           cfg=cfg))
        if topo != big:
            step2 = TR.make_train_step(cfg, TR.make_runtime(m, 4), **STEP_KW)
            p2, o2, _ = step2(tree["params"], tree["opt"], batches[1])
            out["step2"] = _numpy(MD.gather_params(p2, cfg, m))
    one, _ = C.restore_checkpoint(ckpt, device="cpu")
    out["one"] = _numpy(one)
    return out


@pytest.fixture(scope="module")
def got(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from repro import checkpoint as jckpt
    from repro.launch import train as jtrain
    from repro.models import model as JMD
    from repro.optim import adamw as jadamw
    from repro_torch.launch import train as TR
    from repro_torch.models import model as MD
    from repro_torch.optim import adamw
    from test_torch_train import cfg_pair
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("elastic")
    jcfg, _ = cfg_pair("bitnet-1.3b", das=False)
    jp = JMD.init_params(jax.random.PRNGKey(2), jcfg)
    jstep = jax.jit(jtrain.make_train_step(jcfg, jtrain.make_runtime(None, jcfg, 4), **STEP_KW))
    jp, jo, _ = jstep(jp, jadamw.adamw_init(jp), jax.tree.map(jnp.asarray, _batches()[0]))
    jckpt.save_checkpoint(str(tmp / "repro"), 1, {"params": jp, "opt": jo})
    repro_tree = [np.asarray(x) for x in jax.tree.leaves({"params": jp, "opt": jo})]
    cfg = _cfg()
    p = MD.init_params(cfg, seed=0, device="cpu")
    o = adamw.adamw_init(p)
    step = TR.make_train_step(cfg, TR.make_runtime(), **STEP_KW)
    for b in _batches():
        p, o, _ = step(p, o, b)
    outs = run_ranks(elastic_rank, 4, str(tmp / "port"), str(tmp / "repro"))
    return outs, repro_tree, _numpy(p)


def _same(a, b):
    return len(a) == len(b) and all(x.dtype == y.dtype and np.array_equal(x, y)
                                    for x, y in zip(a, b))


def test_restore_at_the_saving_topology_gives_each_rank_its_shards(got):
    outs, _, _ = got
    for rank, o in enumerate(outs):
        assert o["own_back"], rank
        assert _same(o["dp2", 1], o["saved"]), rank


def test_restore_at_dp1_tp2_and_at_one_rank_equals_the_global_tree(got):
    outs, _, _ = got
    saved = outs[0]["saved"]
    for rank, o in enumerate(outs):
        assert _same(o["saved"], saved)
        assert _same(o["one"], saved), rank
        if rank < 2:
            assert _same(o["dp1", 1], saved), rank
        else:
            assert ("dp1", 1) not in o


def test_step_after_the_restore_matches_one_device(got):
    outs, _, one_device = got
    for rank in (0, 1):
        worst = max(float(np.abs(a - b).max()) for a, b in zip(outs[rank]["step2"], one_device))
        assert worst <= TOL, f"rank {rank}: {worst:.2e}"


def test_repro_checkpoint_restores_onto_a_topology(got):
    outs, repro_tree, _ = got
    for rank, o in enumerate(outs):
        assert _same(o["repro dp2"], repro_tree), rank
        if rank < 2:
            assert _same(o["repro dp1"], repro_tree), rank
