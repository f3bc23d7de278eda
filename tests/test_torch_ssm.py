"""The port's SSM pair against the JAX package: rwkv6-3b and gla-1.3b.

The linear-attention engine (``models/linear_attn.py``): the chunked form
and the one-token step against the JAX package's in both modes, at chunks
4/8/16/64 over several chunks, at the clamp, and at the prompt lengths whose
chunk rule the serving trace meets (1100 -> 55, 997 -> 1, 64 -> 32), within
2e-5.  The pieces: log_sigmoid and the head norm against the JAX package's
in float32.  The models: reduced rwkv6-3b and gla-1.3b (d_model 64, 4
heads of 16, d_ff 128) on the JAX package's weights through the bridge,
prefill + 8 decode steps teacher-forced on the JAX greedy tokens within
2e-4 with equal greedy tokens (tests/test_torch_model.py), at prompts of 48
(one chunk), 64 (two chunks of 32) and 61 (a prime: 61 chunks of 1), base-3
packed and int8 trits; the layer-by-layer export.  bfloat16:
tests/test_torch_ssm_bf16.py; the engine: tests/test_torch_ssm_engine.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import get_config as jget_config
from repro.models import linear_attn as JLA
from repro.models import model as JMD
from repro.models import rwkv6 as JR
from repro.models.transformer import Runtime
from repro_torch.bridge import load_serving_tree
from repro_torch.configs import base as tbase
from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models import linear_attn as LA
from repro_torch.models import model as MD
from test_torch_model import _trits

ARCHS = ("rwkv6-3b", "gla-1.3b")


def ssm_pair(arch, fmt="packed", dtype=None, seed=0):
    """(jax cfg, jax serving params, port model on the CPU) of the reduced
    arch on the same weights, in serve format ``fmt``."""
    jcfg = _trits(jbase.reduced(jget_config(arch)), fmt, dtype=dtype)
    tcfg = _trits(tbase.reduced(get_config(arch)), fmt, dtype=dtype)
    sparams = JMD.export_serving(JMD.init_params(jax.random.PRNGKey(seed), jcfg), jcfg)
    return jcfg, sparams, load_serving_tree(jax.tree.map(np.asarray, sparams), tcfg, "cpu")


@pytest.fixture(scope="module")
def pairs():
    """ssm_pair per (arch, format), with the JAX side's jitted prefill and
    decode step: a recurrent cache does not depend on max_len, so one
    compile of the step serves every prompt length."""
    cache = {}

    def get(arch, fmt="packed"):
        if (arch, fmt) not in cache:
            jcfg, sparams, model = ssm_pair(arch, fmt)
            rt = Runtime(kernel_mode="ref")
            fns = (jax.jit(lambda sp, x: JMD.prefill(sp, jcfg, x, rt, max_len=1)),
                   jax.jit(lambda sp, c, tok, t: JMD.decode_step(sp, jcfg, c, tok, t, rt)))
            cache[arch, fmt] = jcfg, sparams, model, fns
        return cache[arch, fmt]
    return get


def _forced(jcfg, sparams, model, fns, prompt, steps=8):
    """tests/test_torch_model.py::_teacher_forced with the JAX functions
    given: prefill + ``steps`` decode steps of both models, each fed the
    JAX side's greedy token -> ([(jax logits, port logits)], (jax caches,
    port caches))."""
    jprefill, jdecode = fns
    jlg, jc = jprefill(sparams, jnp.asarray(prompt)[None])
    tlg, tc = MD.prefill(model, torch.as_tensor(prompt, dtype=torch.long)[None])
    logits = [(np.asarray(jlg), tlg.numpy())]
    for i in range(steps):
        tok, t = int(np.argmax(logits[-1][0][0])), len(prompt) + i
        jlg, jc = jdecode(sparams, jc, jnp.asarray([tok], jnp.int32), jnp.asarray([t], jnp.int32))
        tlg, tc = MD.decode_step(model, tc, torch.tensor([tok]), torch.tensor([t]))
        logits.append((np.asarray(jlg), tlg.numpy()))
    return logits, (jc, tc)


def _inputs(seed, b, l, h, d, la_scale=0.3):
    """q, k, v, log_a, u, s0 as the JAX package's tests draw them (log_a =
    -softplus(n) * la_scale <= 0), in numpy."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, l, h, d)).astype(np.float32) for _ in range(3))
    la = (-np.logaddexp(rng.standard_normal((b, l, h, d)), 0) * la_scale).astype(np.float32)
    u = (rng.standard_normal((h, d)) * 0.1).astype(np.float32)
    s0 = (rng.standard_normal((b, h, d, d)) * 0.5).astype(np.float32)
    return q, k, v, la, u, s0


def _both_chunked(arrs, chunk, mode, with_s0=True):
    q, k, v, la, u, s0 = arrs
    uu = u if mode == "rwkv" else None
    jo, js = JLA.chunked_linear_attn(*map(jnp.asarray, (q, k, v, la)), chunk=chunk, mode=mode,
                                     u=None if uu is None else jnp.asarray(uu),
                                     s0=jnp.asarray(s0) if with_s0 else None)
    to, ts = LA.chunked_linear_attn(*map(torch.from_numpy, (q, k, v, la)), chunk=chunk,
                                    mode=mode, u=None if uu is None else torch.from_numpy(uu),
                                    s0=torch.from_numpy(s0) if with_s0 else None)
    return (np.asarray(jo), to.numpy()), (np.asarray(js), ts.numpy())


@pytest.mark.parametrize("mode", ["gla", "rwkv"])
@pytest.mark.parametrize("chunk", [4, 8, 16, 64])
def test_chunked_linear_attn_matches_jax(mode, chunk):
    """64 tokens in chunks of 4, 8, 16 and 32 (the rule cuts 64 to 32), from
    a carried state: outputs and final state within 2e-5."""
    arrs = _inputs(chunk, 2, 64, 3, 8)
    for want, got in _both_chunked(arrs, chunk, mode):
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("mode", ["gla", "rwkv"])
def test_linear_attn_step_matches_jax(mode):
    """The one-token recurrence (RWKV reads the old state, GLA the new one)
    against the JAX package's, and against the chunked form fed one token
    at a time, within 2e-5."""
    q, k, v, la, u, s0 = _inputs(7, 2, 5, 3, 8)
    uu = u if mode == "rwkv" else None
    s_j, s_t = jnp.asarray(s0), torch.from_numpy(s0)
    for t in range(5):
        args = [x[:, t] for x in (q, k, v, la)]
        jo, s_j = JLA.linear_attn_step(*map(jnp.asarray, args), s_j, mode=mode,
                                       u=None if uu is None else jnp.asarray(uu))
        to, s_t = LA.linear_attn_step(*map(torch.from_numpy, args), s_t, mode=mode,
                                      u=None if uu is None else torch.from_numpy(uu))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=2e-5, atol=2e-5)
    (_, o_chunk), (_, s_chunk) = _both_chunked((q, k, v, la, u, s0), 64, mode)
    np.testing.assert_allclose(s_chunk, s_t.numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(o_chunk[:, -1], to.numpy(), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("mode", ["gla", "rwkv"])
def test_strong_decay_clamp_matches_jax(mode):
    """tests/test_linear_attn.py::test_strong_decay_no_overflow's case, log
    decays far below LOG_A_MIN, in both packages: finite, and equal within
    2e-5; and the step clamps the same way."""
    ones = np.ones((1, 64, 2, 8), np.float32)
    la = np.full((1, 64, 2, 8), -50.0, np.float32)
    u, s0 = np.zeros((2, 8), np.float32), np.zeros((1, 2, 8, 8), np.float32)
    for want, got in _both_chunked((ones, ones, ones, la, u, s0), 64, mode, with_s0=False):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    args = [ones[:, 0], ones[:, 0], ones[:, 0], la[:, 0]]
    jo, js = JLA.linear_attn_step(*map(jnp.asarray, args), jnp.ones((1, 2, 8, 8)), mode=mode)
    to, ts = LA.linear_attn_step(*map(torch.from_numpy, args), torch.ones((1, 2, 8, 8)),
                                 mode=mode)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-7)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=1e-6)


@pytest.mark.parametrize("l,c", [(1100, 55), (997, 1), (64, 32), (700, 50), (300, 50),
                                 (256, 32), (48, 48), (40, 40)])
def test_chunk_rule(l, c):
    """The chunk each prompt length of the serving trace is cut into: the
    largest divisor of L at most 56 once min(64, L) * 1.5 passes 85, so a
    prime above 56 falls to one-token chunks."""
    assert LA.chunk_size(l, LA.CHUNK) == c


@pytest.mark.parametrize("l", [1100, 997, 64])
def test_chunk_rule_matches_jax(l):
    """Both packages sum over the same chunks: at L = 1100 (c = 55), 997
    (c = 1, 997 sequential chunks) and 64 (c = 32) the outputs and states
    agree within 2e-5, GLA and RWKV; and a length that the chunk does not
    divide raises in both."""
    for mode in ("gla", "rwkv"):
        arrs = _inputs(l, 1, l, 1, 4, la_scale=1.0)
        for want, got in _both_chunked(arrs, 64, mode):
            np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    x = np.zeros((1, 20, 1, 4), np.float32)
    with pytest.raises(ValueError, match="divisible"):
        JLA.chunked_linear_attn(*(jnp.asarray(x),) * 4, chunk=16)
    with pytest.raises(ValueError, match="divisible"):
        LA.chunked_linear_attn(*(torch.from_numpy(x),) * 4, chunk=16)


def test_log_sigmoid_matches_jax():
    """jax.nn.log_sigmoid's formula, -(max(-x, 0) + log1p(exp(-|x|))), in
    float32 within 3 ulps of the JAX package's, over |x| up to ~40 and
    beyond, subnormal results flushed to zero as XLA's CPU backend flushes
    them.  Not bitwise: XLA's CPU exp and log1p are its own approximations,
    not libm's (exp alone differs from torch.exp in ~10 % of float32
    values); F.logsigmoid is another formula, up to 3 ulps away too."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(100_000) * 6,
                        [-100.0, -40.0, -1e-8, 0.0, 1e-8, 40.0, 100.0]]).astype(np.float32)
    want = np.asarray(jax.nn.log_sigmoid(jnp.asarray(x)))
    got = L.log_sigmoid(torch.from_numpy(x)).numpy()
    flushed = np.where(np.abs(got) < np.finfo(np.float32).tiny, np.float32(0), got)
    np.testing.assert_array_max_ulp(flushed, want, maxulp=3)
    assert np.isfinite(got).all() and (got <= 0).all()


@pytest.mark.parametrize("which", ["rwkv", "gla"])
def test_group_norm_matches_jax(which):
    """The head norm of both blocks (rwkv6.py::_groupnorm and the same lines
    inline in gla.py::_out) in float32 within 1e-6: the biased variance
    (the unbiased one, torch.var's default, is 0.1 away here) and y * scale
    + bias.  Not bitwise: XLA's rsqrt is not torch's (they differ in a
    third of float32 values, by one ulp)."""
    rng = np.random.default_rng(1)
    h, hd = 4, 16
    x = (rng.standard_normal((2, 37, h * hd)) * 3 + 0.5).astype(np.float32)
    scale, bias = (rng.standard_normal(h * hd).astype(np.float32) for _ in range(2))
    p = L.GroupNorm(h * hd, torch.float32)
    p.scale.copy_(torch.from_numpy(scale))
    p.bias.copy_(torch.from_numpy(bias))
    got = L.group_norm(p.scale, p.bias, torch.from_numpy(x), h, torch.float32).numpy()
    if which == "rwkv":
        want = JR._groupnorm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                             jnp.asarray(x), h, hd)
    else:   # gla.py::_out's norm lines, up to its cast
        of = jnp.asarray(x).reshape(2, 37, h, hd)
        mu, var = of.mean(-1, keepdims=True), of.var(-1, keepdims=True)
        of = ((of - mu) * jax.lax.rsqrt(var + 1e-5)).reshape(2, 37, h * hd)
        want = of * jnp.asarray(scale) + jnp.asarray(bias)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6)
    xh = torch.from_numpy(x).reshape(2, 37, h, hd)
    unbiased = ((xh - xh.mean(-1, keepdim=True)) * torch.rsqrt(xh.var(-1, keepdim=True) + 1e-5))
    assert np.abs(unbiased.reshape(2, 37, -1).numpy() * scale + bias - got).max() > 1e-2


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_loads_every_leaf(pairs, arch):
    """Every leaf of the JAX package's serving tree has its buffer (the
    LoRAs, mixes, bonus and head norm included) and the reverse."""
    jcfg, sparams, model, _ = pairs(arch)
    assert len(model.state_dict()) == len(jax.tree.leaves(sparams))
    assert [bp.kind for bp in model.layers] == list(jcfg.layer_kinds())
    jp = sparams["layers"]["tail"][1][jcfg.layer_pattern[0]]
    tp = getattr(model.layers[1], jcfg.layer_pattern[0])
    lora = "w_decay2" if arch.startswith("rwkv") else "wa2"
    np.testing.assert_array_equal(getattr(tp, lora).numpy(), np.asarray(jp[lora]))
    np.testing.assert_array_equal(tp.wo.packed.numpy(), np.asarray(jp["wo"]["packed"]))


@pytest.mark.parametrize("fmt", ["packed", "int8"])
@pytest.mark.parametrize("n", [48, 64, 61])
@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_prefill_and_decode_match_jax(pairs, arch, n, fmt):
    """Prefill (one chunk at 48, two chunks of 32 at 64, 61 chunks of 1 at
    61) + 8 teacher-forced decode steps within 2e-4 of the JAX package, equal
    greedy tokens, and the recurrent states after them within 2e-4."""
    jcfg, sparams, model, fns = pairs(arch, fmt)
    prompt = np.random.default_rng(n).integers(0, jcfg.vocab, n).astype(np.int32)
    logits, (jc, tc) = _forced(jcfg, sparams, model, fns, prompt)
    for step, (want, got) in enumerate(logits):
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-4, err_msg=f"logits of step {step}")
        assert int(np.argmax(got)) == int(np.argmax(want)), f"greedy token {step}"
    for jl, tl in zip(jc["tail"], tc):
        assert sorted(jl) == sorted(tl)
        for key in tl:
            np.testing.assert_allclose(tl[key].numpy(), np.asarray(jl[key], np.float32),
                                       rtol=0, atol=2e-4, err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_serving_equals_export(arch):
    """The layer-by-layer export is bitwise export_serving(init_params)."""
    cfg = tbase.reduced(get_config(arch))
    a = MD.init_serving(cfg, seed=4, device="cpu").state_dict()
    b = MD.export_serving(MD.init_params(cfg, seed=4, device="cpu"), cfg).state_dict()
    assert sorted(a) == sorted(b)
    for key in a:
        assert torch.equal(a[key], b[key]), key
