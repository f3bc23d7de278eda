"""The port's model against the JAX package's, on the JAX package's weights.

Both configs of the main-path slice: reduced bitnet-1.3b (d_model 64; the
JAX model runs its reference path) and the slab-aligned ``tiny-fused``
config of tests/test_das_fused.py, where every JAX packed layer takes the
fused Pallas path (run in interpret mode).  The JAX export goes through
``repro_torch.bridge``; prefill logits and 8 decode steps teacher-forced on
the JAX greedy tokens must agree within 2e-4 (float32; the frameworks sum in
different orders) and the greedy tokens must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import get_config as jget_config
from repro.models import kvcache as JKV
from repro.models import model as JMD
from repro.models.transformer import Runtime
from repro_torch.bridge import load_serving_tree
from repro_torch.configs import base as tbase
from repro_torch.configs import get_config
from repro_torch.models import kvcache as KV
from repro_torch.models import model as MD


def _fused_cfg(base):
    """tests/test_das_fused.py's FUSED_CFG, built from either package."""
    return base.ModelConfig(
        name="tiny-fused", family="dense", n_layers=2, d_model=320, n_heads=4,
        n_kv_heads=2, head_dim=80, d_ff=320, vocab=256,
        ternary=base.TernaryConfig(das=base.DasConfig(32, 16)),
        lpsa=base.LpsaConfig(sink=4, window=12, chunk=8),
        dtype="float32", remat=False, scan_layers=False)


CONFIGS = {
    "bitnet-reduced": (lambda: jbase.reduced(jget_config("bitnet-1.3b")),
                       lambda: tbase.reduced(get_config("bitnet-1.3b")), "ref"),
    "tiny-fused": (lambda: _fused_cfg(jbase), lambda: _fused_cfg(tbase), "interpret"),
}


def jax_and_port(name: str, seed: int = 0):
    """(jax cfg, jax serving params, port cfg, port TernaryLM on the CPU,
    jax kernel mode) for one config, on the same weights."""
    jcfg_fn, tcfg_fn, mode = CONFIGS[name]
    jcfg, tcfg = jcfg_fn(), tcfg_fn()
    sparams = JMD.export_serving(JMD.init_params(jax.random.PRNGKey(seed), jcfg), jcfg)
    tree = jax.tree.map(np.asarray, sparams)
    return jcfg, sparams, tcfg, load_serving_tree(tree, tcfg, "cpu"), mode


@pytest.fixture(scope="module")
def pairs():
    """jax_and_port per config name, built once per module on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = jax_and_port(name)
        return cache[name]
    return get


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_bridge_loads_every_leaf(pairs, name):
    jcfg, sparams, tcfg, model, _ = pairs(name)
    n_leaves = len(jax.tree.leaves(sparams))
    assert len(model.state_dict()) == n_leaves
    p = sparams["layers"]["tail"][1]["ffn"]["w_out"]
    np.testing.assert_array_equal(model.layers[1].ffn.w_out.packed.numpy(),
                                  np.asarray(p["packed"]))
    assert model.layers[1].ffn.w_out.packed.shape[0] % 16 == 0


@pytest.mark.parametrize("t_end", [16, 48, 104])
def test_ring_from_stream_matches_jax(rng, t_end):
    jcfg = jbase.reduced(jget_config("bitnet-1.3b"))
    tcfg = tbase.reduced(get_config("bitnet-1.3b"))
    sink, window = jcfg.lpsa.sink, jcfg.lpsa.window
    shp = lambda n: (2, n, jcfg.n_kv_heads, jcfg.head_dim_)  # noqa: E731
    state = [rng.standard_normal(shp(n)).astype(np.float32)
             for n in (sink, sink, window, window)]
    want = JKV.ring_from_stream(jcfg, (*map(jnp.asarray, state), jnp.int32(t_end)),
                                sink=sink, window=window)
    got = KV.ring_from_stream(tcfg, (*map(torch.from_numpy, state), t_end),
                              sink=sink, window=window)
    for key in ("k", "v", "pos"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


def _teacher_forced(jcfg, sparams, model, mode, prompt, *, steps=8,
                    serve_sparse=True):
    rt = Runtime(kernel_mode=mode, serve_sparse=serve_sparse)
    max_len = len(prompt) + steps + 1
    jprefill = jax.jit(lambda sp, x: JMD.prefill(sp, jcfg, x, rt, max_len=max_len))
    jdecode = jax.jit(lambda sp, c, tok, t: JMD.decode_step(sp, jcfg, c, tok, t, rt))
    jlg, jc = jprefill(sparams, jnp.asarray(prompt)[None])
    tlg, tc = MD.prefill(model, torch.as_tensor(prompt, dtype=torch.long)[None],
                         max_len=max_len, serve_sparse=serve_sparse)
    logits = [(np.asarray(jlg), tlg.numpy())]
    for i in range(steps):
        tok = int(np.argmax(logits[-1][0][0]))
        t = len(prompt) + i
        jlg, jc = jdecode(sparams, jc, jnp.asarray([tok], jnp.int32),
                          jnp.asarray([t], jnp.int32))
        tlg, tc = MD.decode_step(model, tc, torch.tensor([tok]), torch.tensor([t]),
                                 serve_sparse=serve_sparse)
        logits.append((np.asarray(jlg), tlg.numpy()))
    return logits, (jc, tc)


# full-cache serving (serve_sparse=False) on the reduced config, whose JAX
# reference path is fast; the fused config checks the LPSA path
@pytest.mark.parametrize("name,serve_sparse", [("bitnet-reduced", True),
                                               ("bitnet-reduced", False),
                                               ("tiny-fused", True)])
def test_prefill_and_decode_match_jax(pairs, name, serve_sparse):
    jcfg, sparams, _, model, mode = pairs(name)
    chunk = jcfg.lpsa.chunk
    prompt = np.random.default_rng(1).integers(0, jcfg.vocab, 3 * chunk).astype(np.int32)
    logits, (jc, tc) = _teacher_forced(jcfg, sparams, model, mode, prompt,
                                       serve_sparse=serve_sparse)
    for step, (want, got) in enumerate(logits):
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-4,
                                   err_msg=f"logits of step {step}")
        assert int(np.argmax(got)) == int(np.argmax(want)), f"greedy token {step}"
    if serve_sparse:   # the ring caches after prefill and 8 decode writes agree
        for jl, tl in zip(jc["tail"], tc):
            np.testing.assert_array_equal(tl["pos"].numpy(), np.asarray(jl["pos"]))
            np.testing.assert_allclose(tl["k"].numpy(), np.asarray(jl["k"]), atol=2e-4)
