"""Expert parallelism of the port against the JAX package's single device.

Reduced qwen3-moe-30b-a3b, float32, on the JAX package's weights, in one
world of 4 gloo ranks on the CPU (spawned once for the module):

  * ``moe_apply`` of layer 0 at Topology(tp=2) (ranks 0 and 1, 4 of the 8
    experts each) within 1e-4 of ``repro``'s single-device ``moe_apply``:
    a 32-token prefill at the reduced capacity factor (no drops) and at 1.0
    (copies dropped, the same ones), and a 4-row decode at the engine's
    no-drop capacity;
  * at Topology(dp=2, tp=2) each data half (ranks 2d, 2d + 1) within 1e-4
    of ``repro``'s ``moe_apply`` on that half alone: the capacity comes from
    the rank's own tokens, as the JAX package's ``t_local = (b // dp) * s``;
  * the engine at Topology(dp=2, tp=2): greedy tokens equal to ``repro``'s
    single-device engine.

The ranks run this module's ``moe_rank``; the module imports JAX and the
JAX package only inside the fixture, so the ranks never load them.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import base as tbase
from repro_torch.configs import get_config
from repro_torch.distributed.launch import run_ranks
from repro_torch.distributed.plan import Topology
from repro_torch.launch import serve as cli
from repro_torch.serve import Request, ServeConfig

ARCH, TOL = "qwen3-moe-30b-a3b", 1e-4
# (name, x shape, capacity factor, capacity: None = the capacity-factor bound)
CASES = [("prefill", (4, 8), 4.0, None), ("drops", (4, 8), 1.0, None),
         ("decode", (4, 1), 4.0, "decode")]
TOPOLOGIES = [Topology(tp=2), Topology(dp=2, tp=2)]


def _cfg(base, get, cf):
    cfg = base.reduced(get(ARCH))
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def _inputs(shape, d):
    rng = np.random.default_rng(3)
    return (rng.standard_normal(shape + (d,)).astype(np.float32),
            (0.3 * rng.standard_normal(d)).astype(np.float32))


def _trace(cfg, request=Request):
    rng = np.random.default_rng(7)
    return [request(uid=i, prompt=np.asarray(rng.integers(0, cfg.vocab, (24,)), np.int32),
                    max_new_tokens=8, arrival=2 * i) for i in range(4)]


def moe_rank(rank: int, path: str, job) -> dict:
    """Layer 0's MoE of each rank's shard on every case and topology, then
    the engine job."""
    from repro_torch.models import model as MD
    from repro_torch.models import moe as MOE
    out = {}
    for topo in TOPOLOGIES:
        mesh = topo.build_mesh()
        for name, shape, cf, cap in CASES:
            if not mesh.member:
                continue
            cfg = _cfg(tbase, get_config, cf)
            full = MD.TernaryLM(cfg, "cpu")
            full.load_state_dict(torch.load(path), assign=True)
            local = MD.shard_model(full, mesh, "cpu")
            x, scale = _inputs(shape, cfg.d_model)
            if topo.dp > 1:
                half = shape[0] // topo.dp
                x = x[mesh.data_index * half:(mesh.data_index + 1) * half]
            moe = local.layers[0].moe
            capacity = MOE.decode_capacity(cfg, x.shape[0]) if cap == "decode" else None
            y = MOE.moe_apply(moe, local.cfg, torch.from_numpy(x), torch.from_numpy(scale),
                              capacity=capacity)
            out[(topo, name)] = (y.numpy(), moe.experts, int(moe.dropped))
    out["engine"] = cli.serve_rank(rank, job)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from repro.configs import base as jbase
    from repro.configs import get_config as jget
    from repro.models import layers as JL
    from repro.models import model as JMD
    from repro.models import moe as JMOE
    from repro.models.transformer import Runtime
    from repro.serve import Request as JRequest
    from repro.serve import ServeConfig as JServeConfig
    from repro.serve import ServeEngine as JServeEngine
    from repro_torch.bridge import load_serving_tree
    torch.set_num_threads(1)
    jcfg, tcfg = jbase.reduced(jget(ARCH)), tbase.reduced(get_config(ARCH))
    sparams = JMD.export_serving(JMD.init_params(jax.random.PRNGKey(0), jcfg), jcfg)
    p0 = sparams["layers"]["tail"][0]["moe"]
    want = {}
    for name, shape, cf, cap in CASES:
        jc = _cfg(jbase, jget, cf)
        x, scale = _inputs(shape, jc.d_model)
        for parts in (1, 2):   # the whole batch, and each half alone
            half = shape[0] // parts
            for d in range(parts):
                xn = JL.rmsnorm({"scale": jnp.asarray(scale)},
                                jnp.asarray(x[d * half:(d + 1) * half]))
                c = JMOE.decode_capacity(jc, half) if cap == "decode" else None
                want[(name, parts, d)] = np.asarray(jax.jit(
                    lambda p, v, jc=jc, c=c: JMOE.moe_apply(p, jc, v, capacity=c))(p0, xn))

    eng = JServeEngine(jcfg, sparams, Runtime(), config=JServeConfig(
        max_slots=4, max_len=64, kernel_mode="ref"))
    for r in _trace(jcfg, JRequest):
        eng.submit(r)
    want["tokens"] = {uid: r.tokens.tolist() for uid, r in eng.run().items()}

    path = str(tmp_path_factory.mktemp("dist_moe") / "weights.pt")
    torch.save(load_serving_tree(jax.tree.map(np.asarray, sparams), tcfg, "cpu").state_dict(),
               path)
    job = cli.RankJob(tcfg, ServeConfig(max_slots=4, max_len=64,
                                        topology=Topology(dp=2, tp=2)),
                      weights=path, trace=tuple(_trace(tcfg)))
    return want, run_ranks(moe_rank, 4, path, job)


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_moe_apply_tp2_matches_jax(runs, case):
    want, got = runs
    topo = TOPOLOGIES[0]
    for rank in (0, 1):
        y, experts, dropped = got[rank][(topo, case)]
        assert experts == (4 * rank, 4 * rank + 4)   # each rank holds 4 of the 8
        np.testing.assert_allclose(y, want[(case, 1, 0)], rtol=0, atol=TOL,
                                   err_msg=f"rank {rank}")
        assert (dropped > 0) == (case == "drops")
    np.testing.assert_array_equal(got[0][(topo, case)][0], got[1][(topo, case)][0])
    assert (topo, case) not in got[2]          # ranks 2, 3 sit outside Topology(tp=2)


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_moe_apply_dp2_tp2_matches_jax_per_half(runs, case):
    want, got = runs
    topo = TOPOLOGIES[1]
    for rank in range(4):
        y, experts, _ = got[rank][(topo, case)]
        assert experts == (4 * (rank % 2), 4 * (rank % 2) + 4)
        np.testing.assert_allclose(y, want[(case, 2, rank // 2)], rtol=0, atol=TOL,
                                   err_msg=f"rank {rank}")


def test_engine_dp2_tp2_tokens_match_jax(runs):
    want, got = runs
    for rank in range(4):
        out = got[rank]["engine"]
        assert out["tokens"] == want["tokens"], f"rank {rank}"
        assert out["experts"] == (4 * (rank % 2), 4 * (rank % 2) + 4)
