"""The port's MoE against the JAX package's, on the JAX package's weights.

The module: ``models.moe.moe_apply`` against ``repro.models.moe.moe_apply``
(no mesh) on the same exported experts, float32, for reduced qwen3-moe and
reduced kimi-k2 (its shared expert), DAS on and off, base-3 packed and int8
trits, at the engine's decode capacity over 4 rows and at a 64-token
prefill whose capacity factor is lowered until the JAX package drops copies.
Within 1e-5: the two frameworks sum the expert products in different orders
(observed ~2e-7).

The model: reduced qwen3-moe with its real head size 64 and GQA 8:1 (8 heads
over 1), prefill + 8 teacher-forced decode steps, LPSA on and off: float32
within 2e-4 with equal greedy tokens (the 2e-4 of tests/test_torch_model.py);
bfloat16 against the JAX package run op by op, bitwise equal logits and
equal greedy tokens (read bitwise over all 9 steps, LPSA on and off, at 1,
6 and 8 torch threads).

The pieces: the expert-stack decode and int8 fake-quant exactly, the
layer-by-layer export, the bridge's round trip, the int8-resident form.
The engine and the CLI: tests/test_torch_moe_engine.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import get_config as jget_config
from repro.core import ternary as jtq
from repro.core import twd as jtwd
from repro.models import layers as JL
from repro.models import model as JMD
from repro.models import moe as JMOE
from repro_torch.bridge import load_serving_tree, to_torch
from repro_torch.configs import base as tbase
from repro_torch.configs import get_config
from repro_torch.core import ternary as tq
from repro_torch.kernels import ops, ref
from repro_torch.models import model as MD
from repro_torch.models import moe as MOE
from test_torch_model import _teacher_forced

ARCHS = ("qwen3-moe-30b-a3b", "kimi-k2-1t-a32b")


def moe_cfg(base, get, arch, *, das=True, fmt="packed", capacity_factor=None, **kw):
    """The reduced MoE arch from either package: DAS on or off, the serve
    format, a capacity factor in place of reduced()'s no-drop 4.0."""
    cfg = base.reduced(get(arch))
    tern = dataclasses.replace(cfg.ternary, serve_format=fmt,
                               das=cfg.ternary.das if das else None)
    cfg = dataclasses.replace(cfg, ternary=tern, **kw)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    return cfg


def _flat(tree, prefix="", out=None):
    out = {} if out is None else out
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat(v, f"{prefix}{k}.", out)
    else:
        out[prefix[:-1]] = to_torch(np.asarray(tree))
    return out


def _jax_drops(sp, jcfg, xn, capacity):
    """The routed copies the JAX router sends past ``capacity``: its own
    logits, top-k and expert loads."""
    t = xn.shape[0] * xn.shape[1]
    logits = xn.reshape(t, -1).astype(jnp.float32) @ sp["router"].astype(jnp.float32)
    _, expert = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), jcfg.moe.top_k)
    counts = np.bincount(np.asarray(expert).ravel(), minlength=jcfg.moe.n_experts)
    return int(np.maximum(counts - capacity, 0).sum())


@pytest.mark.parametrize("case", ["decode", "prefill-drops"])
@pytest.mark.parametrize("fmt", ["packed", "int8"])
@pytest.mark.parametrize("das", [True, False], ids=["das", "nodas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_jax(arch, das, fmt, case):
    drops = case == "prefill-drops"
    kw = dict(das=das, fmt=fmt, capacity_factor=1.0 if drops else None)
    jcfg = moe_cfg(jbase, jget_config, arch, **kw)
    tcfg = moe_cfg(tbase, get_config, arch, **kw)
    sp = JMOE.export_moe(JMOE.moe_init(jax.random.PRNGKey(0), jcfg), jcfg)
    m = MOE.MoE(tcfg, torch.float32, "cpu")
    m.load_state_dict(_flat(sp))
    assert hasattr(m, "shared_gate") == (arch == "kimi-k2-1t-a32b")
    rng = np.random.default_rng(0)
    shape = (1, 64) if drops else (4, 1)
    x = rng.standard_normal(shape + (jcfg.d_model,)).astype(np.float32)
    scale = (0.3 * rng.standard_normal(jcfg.d_model)).astype(np.float32)
    xn = JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    cap = None if drops else JMOE.decode_capacity(jcfg, 4)
    want = np.asarray(jax.jit(lambda p, v: JMOE.moe_apply(p, jcfg, v, capacity=cap))(sp, xn))
    got = MOE.moe_apply(m, tcfg, torch.from_numpy(x), torch.from_numpy(scale), capacity=cap)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    jax_drops = _jax_drops(sp, jcfg, xn, MOE.prefill_capacity(tcfg, 64) if drops else cap)
    assert int(m.dropped) == jax_drops
    assert (jax_drops > 0) == drops


def _model_pair(dtype):
    """Reduced qwen3-moe with its real head size and GQA ratio (8 heads of
    64 over 1), as tests/test_torch_zoo.py's zoo_cfg: (jax cfg, jax serving
    params, port model on the CPU) on the same weights."""
    kw = dict(n_heads=8, n_kv_heads=1, head_dim=64, dtype=dtype)
    jcfg = moe_cfg(jbase, jget_config, ARCHS[0], **kw)
    tcfg = moe_cfg(tbase, get_config, ARCHS[0], **kw)
    sp = JMD.export_serving(JMD.init_params(jax.random.PRNGKey(0), jcfg), jcfg)
    return jcfg, sp, load_serving_tree(jax.tree.map(np.asarray, sp), tcfg, "cpu")


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(dtype):
        if dtype not in cache:
            cache[dtype] = _model_pair(dtype)
        return cache[dtype]
    return get


def _prompt(jcfg, n=48):
    return np.random.default_rng(1).integers(0, jcfg.vocab, n).astype(np.int32)


@pytest.mark.parametrize("serve_sparse", [True, False], ids=["lpsa", "full"])
def test_qwen3_moe_matches_jax_f32(pairs, serve_sparse):
    jcfg, sp, model = pairs("float32")
    assert model.layers[0].attn.wq.d_out == 8 * 64 and not hasattr(model.layers[0], "ffn")
    logits, _ = _teacher_forced(jcfg, sp, model, "ref", _prompt(jcfg),
                                serve_sparse=serve_sparse)
    for step, (want, got) in enumerate(logits):
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-4,
                                   err_msg=f"logits of step {step}")
        assert int(np.argmax(got)) == int(np.argmax(want)), f"greedy token {step}"


@pytest.mark.parametrize("serve_sparse", [True, False], ids=["lpsa", "full"])
def test_qwen3_moe_bf16_tokens_match_eager_jax(pairs, serve_sparse):
    jcfg, sp, model = pairs("bfloat16")
    logits, _ = _teacher_forced(jcfg, sp, model, "ref", _prompt(jcfg, 32),
                                serve_sparse=serve_sparse, eager=True)
    for step, (want, got) in enumerate(logits):
        np.testing.assert_array_equal(got, want.astype(np.float32),
                                      err_msg=f"logits of step {step}")
        assert int(np.argmax(got)) == int(np.argmax(want)), f"greedy token {step}"


@pytest.mark.parametrize("k", [64, 128, 61])
def test_twd_decode_stack_matches_jax_unpack(k):
    """The stack decode's plain version (and ops on the CPU) against the JAX
    package's per-expert arithmetic unpack, exactly."""
    rng = np.random.default_rng(k)
    trits = rng.integers(-1, 2, size=(8, k, 96)).astype(np.int8)
    packed = np.stack([np.asarray(jtwd.pack_ternary(jnp.asarray(t), row_align=16))
                       for t in trits])
    want = np.asarray(jax.vmap(lambda pk: jtwd.unpack_ternary_arith(pk, k))(packed))
    np.testing.assert_array_equal(want, trits)
    tp = torch.from_numpy(packed)
    np.testing.assert_array_equal(ref.twd_decode_stack_ref(tp, k).numpy(), want)
    np.testing.assert_array_equal(ops.twd_decode_stack(tp, k).numpy(), want)
    np.testing.assert_array_equal(MOE.pack_stack(torch.from_numpy(trits)).numpy(), packed)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_fake_quant_matches_jax(dtype):
    """Per-token absmax int8 fake-quant, bit for bit against the JAX package
    run op by op (jitted, XLA may turn the division by the scale into a
    product with its reciprocal inside a fusion, one float32 ulp apart)."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((64, 96)) * rng.uniform(0.01, 30, (64, 1))).astype(np.float32)
    x[3] = 0.0                                    # an all-zero token: scale = eps
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = tq.int8_fake_quant(tx).float().numpy()
    with jax.disable_jit():
        eager = np.asarray(jtq.int8_fake_quant(jx)).astype(np.float32)
    np.testing.assert_array_equal(got, eager)
    qa = tq.int8_quantize(tx)
    with jax.disable_jit():
        jqa = jtq.int8_quantize(jx)
    np.testing.assert_array_equal(qa.values.numpy(), np.asarray(jqa.values))
    np.testing.assert_array_equal(qa.scale.numpy(), np.asarray(jqa.scale))


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_round_trips_moe_tree(arch):
    """Every leaf of a reduced JAX MoE serving tree (router, expert stacks,
    per-expert scales, shared linears) lands in the port's model unchanged."""
    jcfg = moe_cfg(jbase, jget_config, arch)
    tcfg = moe_cfg(tbase, get_config, arch)
    tree = jax.tree.map(np.asarray, JMD.export_serving(
        JMD.init_params(jax.random.PRNGKey(2), jcfg), jcfg))
    model = load_serving_tree(tree, tcfg, "cpu")
    own = model.state_dict()
    flat = MD.flatten_tree(tree, tcfg)
    assert sorted(own) == sorted(flat)
    for name, leaf in flat.items():
        np.testing.assert_array_equal(own[name].float().numpy(),
                                      to_torch(leaf).float().numpy(), err_msg=name)
    st = model.layers[1].moe.experts_out
    assert st.packed.shape == (8, 32, tcfg.d_model) and st.scale.shape == (8, 1, 1)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "kimi-k2-1t-a32b", "gemma2-2b"])
def test_init_serving_equals_export_of_init_params(arch):
    """The layer-by-layer export gives the whole-tree export's model, bit
    for bit (a MoE with and without shared experts, and a dense arch); both
    draw the embedding first from the seed, then the blocks, then the head."""
    cfg = tbase.reduced(get_config(arch))
    want = MD.export_serving(MD.init_params(cfg, seed=4, device="cpu"), cfg).state_dict()
    got = MD.init_serving(cfg, seed=4, device="cpu").state_dict()
    assert sorted(got) == sorted(want)
    for name, buf in got.items():
        assert torch.equal(buf, want[name]), name
    gen = torch.Generator().manual_seed(4)
    embed = torch.randn((cfg.vocab_padded, cfg.d_model), generator=gen) * 0.02
    assert torch.equal(got["embed"], embed.to(getattr(torch, cfg.dtype)))


@pytest.mark.parametrize("fmt", ["int8", "bf16"])
def test_moe_trits_from_packed_equals_int8_export(fmt):
    """twd_decode_stack of the packed expert stacks gives exactly the int8
    export of the same master weights, and the same logits."""
    cfg = moe_cfg(tbase, get_config, "kimi-k2-1t-a32b")
    cfg8 = moe_cfg(tbase, get_config, "kimi-k2-1t-a32b", fmt=fmt)
    params = MD.init_params(cfg, seed=5, device="cpu")
    packed, exported = MD.export_serving(params, cfg), MD.export_serving(params, cfg8)
    decoded = MD.trits_from_packed(packed, cfg8)
    own = exported.state_dict()
    assert sorted(decoded.state_dict()) == sorted(own)
    for key, val in decoded.state_dict().items():
        assert torch.equal(val, own[key]), key
    tok = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab, 48))[None]
    np.testing.assert_allclose(MD.prefill(decoded, tok)[0].numpy(),
                               MD.prefill(packed, tok)[0].numpy(), rtol=0, atol=2e-4)


def test_das_topk_dense_beside_compaction():
    """with_dense: the masked dense rows beside the compaction, the same
    function as core.das's mask applied to the normed rows."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((5, 64)).astype(np.float32))
    scale = torch.from_numpy((0.3 * rng.standard_normal(64)).astype(np.float32))
    out = ops.das_topk(x, keep=16, block=32, norm_scale=scale, with_mask=True,
                       with_normed=True, with_dense=True)
    assert out.values is not None and out.dense is not None
    assert torch.equal(out.dense, out.normed * out.mask.to(torch.float32))
    plain = ops.das_topk(x, keep=16, block=32, norm_scale=scale)
    assert plain.dense is None and torch.equal(plain.values, out.values)
