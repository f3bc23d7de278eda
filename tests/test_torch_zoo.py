"""The dense zoo against the JAX package: bitnet-3b, gemma2-2b, gemma3-1b,
minicpm-2b and stablelm-1.6b, each reduced (d_model 64, 2 layers a
pattern period) but with the arch's real head size (100, 256 or 64), its
GQA ratio, its layer pattern, activation, soft-caps, embedding scale and
tied or untied head, the same ``dataclasses.replace`` on both sides.

float32: prefill + 8 decode steps teacher-forced on the JAX greedy tokens,
logits within 2e-4 and equal greedy tokens, with LPSA on and off (the
2e-4 of tests/test_torch_model.py).  Then the pieces alone: gelu over every
finite bfloat16 value, the embedding scale.  The bfloat16 models and the
engine: tests/test_torch_zoo_bf16.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import get_config as jget_config
from repro.models import model as JMD
from repro_torch.bridge import load_serving_tree
from repro_torch.configs import base as tbase
from repro_torch.configs import get_config
from repro_torch.models import layers as L
from test_torch_model import _teacher_forced

# arch -> (n_heads, n_kv_heads, head_dim): the arch's GQA ratio at a few
# heads, its real head size
ZOO = {
    "bitnet-3b": (2, 2, 100),
    "gemma2-2b": (4, 2, 256),
    "gemma3-1b": (4, 1, 256),
    "minicpm-2b": (2, 2, 64),
    "stablelm-1.6b": (2, 2, 64),
}


def zoo_cfg(base, get, arch, **kw):
    """The reduced arch with its real head size and GQA ratio, from either
    package; ``kw`` goes to ``reduced`` (n_layers) or ``replace``."""
    n_heads, n_kv, hd = ZOO[arch]
    red = {k: kw.pop(k) for k in ("n_layers",) if k in kw}
    cfg = base.reduced(get(arch), **red)
    return dataclasses.replace(cfg, n_heads=n_heads, n_kv_heads=n_kv, head_dim=hd, **kw)


def zoo_pair(arch, seed=0, **kw):
    """(jax cfg, jax serving params, port model on the CPU) on the same
    weights."""
    jcfg = zoo_cfg(jbase, jget_config, arch, **kw)
    tcfg = zoo_cfg(tbase, get_config, arch, **kw)
    sparams = JMD.export_serving(JMD.init_params(jax.random.PRNGKey(seed), jcfg), jcfg)
    tree = jax.tree.map(np.asarray, sparams)
    return jcfg, sparams, load_serving_tree(tree, tcfg, "cpu")


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(arch, **kw):
        key = (arch, tuple(sorted(kw.items())))
        if key not in cache:
            cache[key] = zoo_pair(arch, **kw)
        return cache[key]
    return get


def _prompt(jcfg, n=48):
    return np.random.default_rng(1).integers(0, jcfg.vocab, n).astype(np.int32)


@pytest.mark.parametrize("arch", sorted(ZOO))
def test_bridge_loads_every_leaf(pairs, arch):
    jcfg, sparams, model = pairs(arch)
    assert len(model.state_dict()) == len(jax.tree.leaves(sparams))
    assert [bp.kind for bp in model.layers] == list(jcfg.layer_kinds())
    assert model.layers[0].attn.wq.d_out == jcfg.n_heads * ZOO[arch][2]
    assert hasattr(model, "head") == (not jcfg.tie_embeddings)
    assert model.embed_scale == arch.startswith("gemma")
    np.testing.assert_array_equal(model.layers[-1].ffn.w_out.packed.numpy(), np.asarray(
        sparams["layers"]["tail"][-1]["ffn"]["w_out"]["packed"]))


@pytest.mark.parametrize("serve_sparse", [True, False], ids=["lpsa", "full"])
@pytest.mark.parametrize("arch", sorted(ZOO))
def test_zoo_matches_jax_f32(pairs, arch, serve_sparse):
    jcfg, sparams, model = pairs(arch)
    logits, _ = _teacher_forced(jcfg, sparams, model, "ref", _prompt(jcfg),
                                serve_sparse=serve_sparse)
    for step, (want, got) in enumerate(logits):
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-4,
                                   err_msg=f"logits of step {step}")
        assert int(np.argmax(got)) == int(np.argmax(want)), f"greedy token {step}"


def test_gelu_matches_jax_on_every_bf16():
    """The port's gelu is jax.nn.gelu(approximate=True) bit for bit on every
    finite bfloat16 value.  XLA's CPU backend flushes subnormals to zero, so
    the port runs under the same flush here (torch.set_flush_denormal); the
    one-rounding F.gelu differs from it.  The flush is a mode of the calling
    thread, so the port runs on one thread here."""
    x = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16).view(jnp.bfloat16)
    x = x[np.isfinite(x.astype(np.float32))]
    want = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=True)).astype(np.float32)
    tx = torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    assert torch.set_flush_denormal(True)
    try:
        got, loose = L.gelu(tx), torch.nn.functional.gelu(tx, approximate="tanh")
    finally:
        torch.set_flush_denormal(False)
        torch.set_num_threads(threads)
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert not np.array_equal(loose.float().numpy(), want)


@pytest.mark.parametrize("d,want", [(1152, 34.0), (2304, 48.0)])
def test_embedding_scale_bf16(d, want):
    """gemma's sqrt(d) input scale is rounded to bfloat16 first, as the JAX
    package's take_embed rounds it: 34.0 at d = 1152 (not 33.94)."""
    embed = torch.ones((4, d), dtype=torch.bfloat16)
    x = L.take_embed(embed, torch.tensor([2]), scale=True)
    assert x.dtype == torch.bfloat16 and float(x[0, 0]) == want
    jx = JMD.L.take_embed(jnp.ones((4, d), jnp.bfloat16), jnp.asarray([2]), scale=True)
    assert float(jx[0, 0]) == want
    assert torch.equal(L.take_embed(embed, torch.tensor([2])), embed[[2]])
