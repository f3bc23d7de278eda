"""The port's model against the JAX package's, on the JAX package's weights.

Both configs of the main-path slice: reduced bitnet-1.3b (d_model 64; the
JAX model runs its reference path) and the slab-aligned ``tiny-fused``
config of tests/test_das_fused.py, where every JAX packed layer takes the
fused Pallas path (run in interpret mode).  The JAX export goes through
``repro_torch.bridge``; prefill logits and 8 decode steps teacher-forced on
the JAX greedy tokens must agree within 2e-4 (float32; the frameworks sum in
different orders) and the greedy tokens must be equal.
"""
import contextlib
import dataclasses

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
from repro_torch.kernels import ops
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


def _trits(cfg, fmt, *, baseline=False, dtype=None):
    """The int8-resident serve formats, as launch/dryrun.py builds its
    int8w / bf16w / baseline variants with dataclasses.replace: "baseline"
    is int8 weights, no DAS, no LPSA (full attention)."""
    tern = dataclasses.replace(cfg.ternary, serve_format=fmt)
    if baseline:
        tern = dataclasses.replace(tern, das=None)
    cfg = dataclasses.replace(cfg, ternary=tern)
    if baseline:
        cfg = dataclasses.replace(cfg, lpsa=None)
    return cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype)


def _bitnet_trits(base, get, fmt, **kw):
    return lambda: base.reduced(_trits(get("bitnet-1.3b"), fmt, **kw))


# the trits path: the JAX package applies trits with jnp (no kernel mode).
# The bfloat16 model is the baseline: with DAS on, one-ulp differences in
# where the two frameworks round bfloat16 flip lanes of the top-k mask, so
# its logits are held to greedy tokens only (test_bf16_das_model_tokens).
TRITS_CONFIGS = {
    "bitnet-reduced-int8": (_bitnet_trits(jbase, jget_config, "int8"),
                            _bitnet_trits(tbase, get_config, "int8"), "ref"),
    "bitnet-reduced-bf16": (_bitnet_trits(jbase, jget_config, "bf16"),
                            _bitnet_trits(tbase, get_config, "bf16"), "ref"),
    "tiny-fused-int8": (lambda: _trits(_fused_cfg(jbase), "int8"),
                        lambda: _trits(_fused_cfg(tbase), "int8"), "ref"),
    "baseline-reduced": (_bitnet_trits(jbase, jget_config, "int8", baseline=True),
                         _bitnet_trits(tbase, get_config, "int8", baseline=True), "ref"),
    "baseline-reduced-bfloat16": (
        lambda: _trits(jbase.reduced(_trits(jget_config("bitnet-1.3b"), "int8", baseline=True)),
                       "int8", baseline=True, dtype="bfloat16"),
        lambda: _trits(tbase.reduced(_trits(get_config("bitnet-1.3b"), "int8", baseline=True)),
                       "int8", baseline=True, dtype="bfloat16"), "ref"),
}


def _bf16_das(base, get):
    return _trits(base.reduced(_trits(get("bitnet-1.3b"), "int8")), "int8",
                  dtype="bfloat16")


def _bf16_packed(base, get):
    """The main path's own format (base-3 packed) in bfloat16, DAS on."""
    return dataclasses.replace(base.reduced(get("bitnet-1.3b")), dtype="bfloat16")


def _local_softcap(base, get):
    """A local layer before a global one, with attention and logit soft-caps
    (the gemma pattern on bitnet's widths)."""
    return dataclasses.replace(base.reduced(get("bitnet-1.3b")), layer_pattern=("local", "attn"),
                               window=24, attn_softcap=50.0, logit_softcap=30.0)


ALL_CONFIGS = {**CONFIGS, **TRITS_CONFIGS, "bitnet-reduced-int8-bfloat16": (
    lambda: _bf16_das(jbase, jget_config), lambda: _bf16_das(tbase, get_config), "ref"),
    "bitnet-reduced-packed-bfloat16": (lambda: _bf16_packed(jbase, jget_config),
                                       lambda: _bf16_packed(tbase, get_config), "ref"),
    "bitnet-reduced-local-softcap": (lambda: _local_softcap(jbase, jget_config),
                                     lambda: _local_softcap(tbase, get_config), "ref")}


def jax_and_port(name: str, seed: int = 0):
    """(jax cfg, jax serving params, port cfg, port TernaryLM on the CPU,
    jax kernel mode) for one config, on the same weights."""
    jcfg_fn, tcfg_fn, mode = ALL_CONFIGS[name]
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
                    serve_sparse=True, eager=False):
    """Prefill + ``steps`` decode steps of both models, each fed the JAX
    side's greedy token.  ``eager`` runs the JAX side op by op under
    jax.disable_jit(): jitted, XLA may skip bfloat16 roundings inside a
    fusion, so only the eager reference rounds where its code says."""
    rt = Runtime(kernel_mode=mode, serve_sparse=serve_sparse)
    max_len = len(prompt) + steps + 1
    jprefill = jax.jit(lambda sp, x: JMD.prefill(sp, jcfg, x, rt, max_len=max_len))
    jdecode = jax.jit(lambda sp, c, tok, t: JMD.decode_step(sp, jcfg, c, tok, t, rt))
    with jax.disable_jit() if eager else contextlib.nullcontext():
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


@pytest.mark.parametrize("name", sorted(TRITS_CONFIGS))
def test_trits_prefill_and_decode_match_jax(pairs, name):
    """The int8-resident formats (das_gemv on every projection): the JAX
    package's trits export through the bridge, prefill + 8 teacher-forced
    decode steps within 2e-4 (2e-2 for the bfloat16 model, whose scale is
    applied rounded to bfloat16) and equal greedy tokens."""
    jcfg, sparams, tcfg, model, mode = pairs(name)
    lin = model.layers[0].ffn.w_out
    np.testing.assert_array_equal(lin.trits.numpy(), np.asarray(
        sparams["layers"]["tail"][0]["ffn"]["w_out"]["trits"]))
    assert not hasattr(lin, "packed") and lin.trits.shape == (tcfg.d_ff, tcfg.d_model)
    chunk = jcfg.lpsa.chunk if jcfg.lpsa else 16
    prompt = np.random.default_rng(1).integers(0, jcfg.vocab, 3 * chunk).astype(np.int32)
    logits, _ = _teacher_forced(jcfg, sparams, model, mode, prompt)
    tol = 2e-2 if tcfg.dtype == "bfloat16" else 2e-4
    for step, (want, got) in enumerate(logits):
        np.testing.assert_allclose(got, want, rtol=0, atol=tol,
                                   err_msg=f"logits of step {step}")
        assert int(np.argmax(got)) == int(np.argmax(want)), f"greedy token {step}"


@pytest.mark.parametrize("fmt", ["int8", "bf16"])
def test_trits_from_packed_equals_int8_export(fmt):
    """twd_decode of a packed model's weights gives exactly the int8 export
    of the same master weights, and the same logits."""
    cfg = tbase.reduced(get_config("bitnet-1.3b"))
    cfg8 = _trits(cfg, fmt)
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
    with pytest.raises(ValueError, match="no trits"):
        MD.trits_from_packed(packed, cfg)
    ops.reset_launches()   # the CPU decode launches no kernel
    MD.trits_from_packed(packed, cfg8)
    assert ops.launches["twd_decode"] == 0


def test_bf16_das_model_tokens_match_jax(pairs):
    """Reduced bitnet-1.3b in bfloat16 with DAS on (int8 trits) against the
    jitted JAX reference: prefill logits within 2e-2 and equal greedy tokens
    over prefill + 8 teacher-forced decode steps.  The logits are held
    bitwise against the eager reference (test_bf16_das_model_matches_eager_jax):
    the jitted one may skip bfloat16 roundings inside XLA's fusions, and a
    one-ulp difference can flip lanes of the DAS top-k mask, which moves the
    next projections by whole activations."""
    jcfg, sparams, _, model, mode = pairs("bitnet-reduced-int8-bfloat16")
    prompt = np.random.default_rng(1).integers(0, jcfg.vocab, 48).astype(np.int32)
    logits, _ = _teacher_forced(jcfg, sparams, model, mode, prompt)
    np.testing.assert_allclose(logits[0][1], logits[0][0], rtol=0, atol=2e-2)
    for step, (want, got) in enumerate(logits):
        assert int(np.argmax(got)) == int(np.argmax(want)), f"greedy token {step}"


def test_silu_matches_jax_bf16():
    """The port's SiLU rounds like jax.nn.silu in bfloat16, bit for bit;
    F.silu (one rounding) does not."""
    from repro_torch.models.layers import silu
    x = (np.random.default_rng(7).standard_normal(200_000) * 4).astype(np.float32)
    want = np.asarray(jax.nn.silu(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    tx = torch.from_numpy(x).to(torch.bfloat16)
    np.testing.assert_array_equal(silu(tx).float().numpy(), want)
    assert not np.array_equal(torch.nn.functional.silu(tx).float().numpy(), want)


@pytest.mark.parametrize("fmt,serve_sparse", [
    pytest.param("int8", True, id="True"), pytest.param("int8", False, id="False"),
    pytest.param("packed", True, id="packed-True"),
    pytest.param("packed", False, id="packed-False")])
def test_bf16_das_model_matches_eager_jax(pairs, fmt, serve_sparse):
    """Reduced bitnet-1.3b in bfloat16 with DAS on, on int8 trits and on the
    main path's base-3 packed weights, against the JAX package run op by op
    (jax.disable_jit): prefill + 8 teacher-forced decode steps give bitwise
    equal logits, on the LPSA path (streaming prefill, ring decode) and the
    full-cache path.  It rests on the port rounding where the reference
    rounds: SiLU step by step (models/layers.py::silu), the streaming
    prefill's scores to bfloat16 before the scale (ops.sparse_attention
    round_scores) and the rmsnorm before q/k/v and gate/up, which runs
    inside the DAS step (ops.das_topk norm_scale)."""
    jcfg, sparams, _, model, mode = pairs(f"bitnet-reduced-{fmt}-bfloat16")
    prompt = np.random.default_rng(1).integers(0, jcfg.vocab, 48).astype(np.int32)
    logits, _ = _teacher_forced(jcfg, sparams, model, mode, prompt,
                                serve_sparse=serve_sparse, eager=True)
    for step, (want, got) in enumerate(logits):
        np.testing.assert_array_equal(got, want.astype(np.float32),
                                      err_msg=f"logits of step {step}")


@pytest.mark.parametrize("serve_sparse", [True, False])
def test_local_softcap_model_matches_jax(pairs, serve_sparse):
    """A local (sliding-window) layer and a global one, with the attention
    and logit soft-caps, in float32: prefill + 8 teacher-forced decode steps
    within 2e-4 of the JAX package and equal greedy tokens, with LPSA on the
    global layer and without."""
    jcfg, sparams, _, model, mode = pairs("bitnet-reduced-local-softcap")
    assert [bp.kind for bp in model.layers] == ["local", "attn"]
    prompt = np.random.default_rng(1).integers(0, jcfg.vocab, 48).astype(np.int32)
    logits, _ = _teacher_forced(jcfg, sparams, model, mode, prompt,
                                serve_sparse=serve_sparse)
    for step, (want, got) in enumerate(logits):
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-4,
                                   err_msg=f"logits of step {step}")
        assert int(np.argmax(got)) == int(np.argmax(want)), f"greedy token {step}"
