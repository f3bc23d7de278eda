"""The port's GPipe pipeline against the JAX package's composition of its
stages.

``split_stages`` equals ``repro``'s.  In one world of 4 gloo ranks on the
CPU (spawned once for the module), ``pipeline_apply`` over the "pod" axis:

  * 2 stages (ranks 0 and 1) of ``repro``'s test stage, tanh(x @ W[s]), 4
    microbatches: the output within 1e-5 of ``stage_fn(W[1], stage_fn(W[0],
    xb))`` and the gradient of sum(y^2) within 1e-4 of its ``jax.grad``
    (tests/test_multidevice.py:78-102, which fails under JAX 0.9.0 at the
    pipeline's backward: ROADMAP "State of the reference");
  * 4 stages, one a rank (stages in the middle receive and send);
  * 2 stages of one reduced bitnet-1.3b block each at Topology(pods=2,
    dp=1, tp=2): each pod's two ranks run ``block_train`` on their "model"
    shard, the activation hops between the pods' ranks of one model index;
    the output within 1e-5 of ``repro``'s two ``block_train`` calls and the
    gradient of every block leaf (gathered over "model") within 1e-4 of its
    max (float32, DAS off).

The ranks run this module's ``pipeline_rank``; JAX and the JAX package are
imported only in the tests.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import base as tbase
from repro_torch.configs import get_config
from repro_torch.distributed.launch import run_ranks
from repro_torch.distributed.pipeline import split_stages
from repro_torch.distributed.plan import Topology

FWD_TOL, GRAD_TOL, M = 1e-5, 1e-4, 4


def _tanh_inputs(stages):
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((stages, 16, 16)) * 0.3).astype(np.float32)
    return w, rng.standard_normal((8, 16)).astype(np.float32)


def _block_cfg():
    cfg = tbase.reduced(get_config("bitnet-1.3b"))
    return dataclasses.replace(cfg, ternary=dataclasses.replace(cfg.ternary, das=None))


def _block_inputs(d):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 32, d)).astype(np.float32)
    return x, rng.standard_normal(x.shape).astype(np.float32)


def tanh_stage(w, xb):
    return torch.tanh(xb @ w)


def pipeline_rank(rank: int, blocks) -> dict:
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.launch import train as TR
    from repro_torch.models import model as MD
    from repro_torch.models import transformer as T
    from repro_torch.models.ternary_linear import shard_scales
    from repro_torch.tree import leaves, unflatten
    out = {}
    for stages in (2, 4):
        mesh = Topology(pods=stages).build_mesh()
        if not mesh.member:
            continue
        w, xb = _tanh_inputs(stages)
        ws = torch.from_numpy(w[mesh.pod_index]).requires_grad_()
        y = pipeline_apply(tanh_stage, ws, torch.from_numpy(xb), mesh=mesh, n_microbatches=M)
        (g,) = torch.autograd.grad((y ** 2).sum(), [ws])
        out[stages] = (y.detach().numpy(), g.numpy())
    mesh = Topology(pods=2, dp=1, tp=2).build_mesh()
    cfg = _block_cfg()
    bp = MD.shard_params(blocks[mesh.pod_index], cfg, mesh)
    flat = [t.requires_grad_() for t in leaves(bp)]
    lcfg, rt = MD.local_config(cfg, mesh), TR.make_runtime(mesh, 4)
    x, ct = _block_inputs(cfg.d_model)

    def stage(p, xm):
        return T.block_train(p, lcfg, xm, "attn", None, rt)
    y = pipeline_apply(stage, shard_scales(bp, mesh), torch.from_numpy(x), mesh=mesh,
                       n_microbatches=M)
    grads = torch.autograd.grad((y * torch.from_numpy(ct)).sum(), flat)
    full = MD.gather_params(unflatten(bp, list(grads)), cfg, mesh)
    out["blocks"] = (y.detach().numpy(), [g.numpy() for g in leaves(full)], mesh.pod_index)
    return out


@pytest.fixture(scope="module")
def got():
    import jax

    from repro.models import model as JMD
    from repro_torch.bridge import to_torch
    from test_torch_train import cfg_pair
    torch.set_num_threads(1)
    jcfg, _ = cfg_pair("bitnet-1.3b", das=False)
    jp = JMD.init_params(jax.random.PRNGKey(0), jcfg)
    blocks = [jax.tree.map(np.asarray, b) for b in jp["layers"]["tail"]]
    return blocks, run_ranks(pipeline_rank, 4, [jax.tree.map(to_torch, b) for b in blocks])


def test_split_stages_matches_repro():
    from repro.distributed.pipeline import split_stages as jsplit
    for n in (1, 2, 5, 8, 9):
        seq = tuple(range(n))
        for s in (1, 2, 3, 4):
            assert split_stages(seq, s) == jsplit(seq, s)


@pytest.mark.parametrize("stages", [2, 4])
def test_pipeline_matches_the_composition(got, stages):
    import jax
    import jax.numpy as jnp
    _, outs = got
    w, xb = _tanh_inputs(stages)

    def composed(ws):
        y = jnp.asarray(xb)
        for s in range(stages):
            y = jnp.tanh(y @ ws[s])
        return y
    y_ref = np.asarray(composed(jnp.asarray(w)))
    g_ref = np.asarray(jax.grad(lambda ws: jnp.sum(composed(ws) ** 2))(jnp.asarray(w)))
    ranks = [r for r, o in enumerate(outs) if stages in o]
    assert ranks == list(range(stages))
    for r in ranks:
        y, g = outs[r][stages]
        np.testing.assert_allclose(y, y_ref, rtol=FWD_TOL, atol=FWD_TOL)
        np.testing.assert_allclose(g, g_ref[r], rtol=GRAD_TOL, atol=GRAD_TOL)


def test_tensor_parallel_block_pipeline_matches_repro(got):
    import jax
    import jax.numpy as jnp

    from repro.models import transformer as JT
    from repro.models.transformer import Runtime as JRuntime
    from test_torch_train import cfg_pair
    blocks, outs = got
    jcfg, _ = cfg_pair("bitnet-1.3b", das=False)
    x, ct = _block_inputs(jcfg.d_model)

    def two(bs):
        y = jnp.asarray(x)
        for b in bs:
            y = JT.block_train(b, jcfg, y, "attn", None, JRuntime())
        return y
    y_ref = np.asarray(jax.jit(two)(blocks))
    g_ref = jax.jit(jax.grad(lambda bs: jnp.sum(two(bs) * ct)))(blocks)
    for rank, o in enumerate(outs):
        y, grads, pod = o["blocks"]
        assert np.abs(y - y_ref).max() <= FWD_TOL * np.abs(y_ref).max(), rank
        want = [np.asarray(g) for g in jax.tree.leaves(g_ref[pod])]
        assert len(grads) == len(want)
        for g, w in zip(grads, want):
            assert np.abs(g - w).max() <= GRAD_TOL * max(np.abs(w).max(), 1e-30), rank
