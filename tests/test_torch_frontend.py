"""The stub-frontend models against the JAX package: musicgen-medium and
pixtral-12b, whose prompts are float32 embeddings (P, d_model).

Each reduced (d_model 64, 2 layers) with its own FFN, activation, untied
head and RoPE theta, and its real head size: musicgen-medium's 2-matrix
gelu MLP at 2 heads of 64 over 2, pixtral-12b's gated silu FFN at 4 heads
of 160 over 1 (its GQA ratio of 32 over 8, its head size), the same
``dataclasses.replace`` on both sides.

float32: the MLP FFN module alone against the JAX package's ``ffn_apply``;
then two prompts of embeddings (37 and 34 rows) prefilled at B = 2 on
their pack-aligned 32 rows, and 10 decode steps in which row 0 feeds 5
tail rows and row 1 feeds 2 through ``forced`` / ``forced_x`` while the
other row decodes token ids teacher-forced on the JAX greedy tokens, as the
JAX engine builds its decode input: logits within 2e-4 and equal greedy
tokens, with DAS and LPSA on and off, base-3 packed and int8 trits.  A step
in which one of the port's DAS inputs holds a near tie (a 32-lane block
whose 16th and 17th largest magnitudes are within 1e-5 of each other,
relative: a few float32 ulps, the size of the two frameworks' differing sum
orders) may keep the other lane on the JAX side; such a step is held to
1e-2 and equal greedy tokens (pixtral-12b with DAS on and LPSA off has one,
at a relative gap of 5.8e-7, and its logits move by 5.9e-4).  The
bfloat16 config: tests/test_torch_frontend_bf16.py; the engine and the CLI:
tests/test_torch_frontend_engine.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import get_config as jget_config
from repro.models import layers as JL
from repro.models import model as JMD
from repro.models import transformer as JT
from repro.models.transformer import Runtime
from repro_torch.bridge import load_serving_tree, to_torch
from repro_torch.configs import base as tbase
from repro_torch.configs import get_config
from repro_torch.kernels import ref
from repro_torch.models import model as MD
from repro_torch.models import transformer as T
from repro_torch.models.layers import rmsnorm
from test_torch_hybrid import one_thread  # noqa: F401

# arch -> (n_heads, n_kv_heads, head_dim): its GQA ratio at a few heads, its
# real head size
FRONTENDS = {"musicgen-medium": (2, 2, 64), "pixtral-12b": (4, 1, 160)}
TAILS = (5, 2)          # embedding rows each batch row feeds after the prefix


def frontend_cfg(base, get, arch, *, das=True, fmt="packed", **kw):
    """The reduced arch with its real head size and GQA ratio, from either
    package; ``das=False`` turns DAS off, ``fmt`` is the serve format."""
    n_heads, n_kv, hd = FRONTENDS[arch]
    cfg = base.reduced(get(arch))
    tern = dataclasses.replace(cfg.ternary, serve_format=fmt,
                               **({} if das else {"das": None}))
    return dataclasses.replace(cfg, n_heads=n_heads, n_kv_heads=n_kv, head_dim=hd,
                               ternary=tern, **kw)


def frontend_pair(arch, seed=0, **kw):
    """(jax cfg, jax serving params, port model on the CPU) on the same
    weights."""
    jcfg = frontend_cfg(jbase, jget_config, arch, **kw)
    tcfg = frontend_cfg(tbase, get_config, arch, **kw)
    sparams = JMD.export_serving(JMD.init_params(jax.random.PRNGKey(seed), jcfg), jcfg)
    return jcfg, sparams, load_serving_tree(jax.tree.map(np.asarray, sparams), tcfg, "cpu")


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(arch, **kw):
        key = (arch, tuple(sorted(kw.items())))
        if key not in cache:
            cache[key] = frontend_pair(arch, **kw)
        return cache[key]
    return get


def embed_prompts(d_model, lens, seed=1):
    """Seeded float32 embedding prompts, one (P, d_model) array a length."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, d_model)).astype(np.float32) for n in lens]


class NearTies:
    """Records, for each step, the smallest relative gap between the 16th
    and 17th largest magnitudes of any 32-lane block that the port's DAS
    steps rank (the CPU runs ``ref.das_topk_ref``)."""

    def __init__(self, monkeypatch):
        self.gaps, self.orig = [], ref.das_topk_ref
        monkeypatch.setattr(ref, "das_topk_ref", self._spy)

    def step(self):
        self.gaps.append(np.inf)

    def _spy(self, x, **kw):
        xs = x if kw.get("norm_scale") is None else rmsnorm(kw["norm_scale"], x)
        if self.gaps and xs.shape[-1] % 32 == 0:
            a = xs.abs().reshape(-1, 32).sort(-1, descending=True).values
            gap = ((a[:, 15] - a[:, 16]) / a[:, 15].clamp_min(1e-30)).min().item()
            self.gaps[-1] = min(self.gaps[-1], gap)
        return self.orig(x, **kw)


def forced_teacher(jcfg, sparams, model, prompts, prefix, *, steps=10, serve_sparse=True,
                   ties=None):
    """Both models prefill the prompts' first ``prefix`` rows at B = 2, then
    take ``steps`` decode steps: row b feeds its remaining prompt rows as
    forced embeddings, then the JAX side's greedy tokens.  -> [(jax logits,
    port logits)] of the prefill and every step; ``ties`` (NearTies), when
    given, records each of them as a step."""
    step = ties.step if ties is not None else (lambda: None)
    rt = Runtime(serve_sparse=serve_sparse)
    max_len = max(len(p) for p in prompts) + steps + 1
    b, d = len(prompts), jcfg.d_model
    head = np.stack([p[:prefix] for p in prompts])
    jprefill = jax.jit(lambda sp, x: JMD.prefill(sp, jcfg, x, rt, max_len=max_len))

    def jstep(sp, c, tok, t, forced, fx):   # the JAX engine's decode input
        x = jnp.take(sp["embed"], tok, axis=0).astype(jnp.float32)
        x = jnp.where(forced[:, None], fx, x)[:, None, :]
        return JMD.decode_step(sp, jcfg, c, x, t, rt)

    jdecode = jax.jit(jstep)
    jlg, jc = jprefill(sparams, jnp.asarray(head))
    step()
    tlg, tc = MD.prefill(model, torch.from_numpy(head), max_len=max_len,
                         serve_sparse=serve_sparse)
    logits = [(np.asarray(jlg), tlg.numpy())]
    for i in range(steps):
        t = prefix + i
        forced = np.array([t < len(p) for p in prompts])
        fx = np.zeros((b, d), np.float32)
        tok = np.zeros((b,), np.int32)
        for r, p in enumerate(prompts):
            if forced[r]:
                fx[r] = p[t]
            else:
                tok[r] = int(np.argmax(logits[-1][0][r]))
        jlg, jc = jdecode(sparams, jc, jnp.asarray(tok), jnp.full((b,), t, jnp.int32),
                          jnp.asarray(forced), jnp.asarray(fx))
        step()
        tlg, tc = MD.decode_step(model, tc, torch.from_numpy(tok).long(),
                                 torch.full((b,), t), serve_sparse=serve_sparse,
                                 forced=torch.from_numpy(forced), forced_x=torch.from_numpy(fx))
        logits.append((np.asarray(jlg), tlg.numpy()))
    return logits


NEAR_TIE = 1e-5       # a relative gap of a few float32 ulps
TIE_TOL = 1e-2        # the logits of a step at a near tie


def assert_close(logits, ties=None, atol=2e-4):
    """Logits within ``atol`` and equal greedy tokens at every step; a step
    at a DAS near tie (``ties``) within TIE_TOL."""
    for step, (want, got) in enumerate(logits):
        tie = ties is not None and ties.gaps[step] < NEAR_TIE
        np.testing.assert_allclose(got, want, rtol=0, atol=TIE_TOL if tie else atol,
                                   err_msg=f"logits of step {step}")
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1),
                                      err_msg=f"greedy tokens of step {step}")


@pytest.fixture()
def ties(monkeypatch):
    return NearTies(monkeypatch)


@pytest.mark.parametrize("arch", sorted(FRONTENDS))
def test_bridge_loads_every_leaf(pairs, arch):
    """The JAX export's leaves are the port's buffers: the MLP holds w_in and
    w_out only, the untied head stays, and no frontend is refused."""
    jcfg, sparams, model = pairs(arch)
    assert MD.uses_embeds(model.cfg) and jcfg.frontend != "none"
    assert len(model.state_dict()) == len(jax.tree.leaves(sparams))
    ffn = model.layers[0].ffn
    assert hasattr(ffn, "w_gate") == (jcfg.ffn_kind == "gated")
    assert set(sparams["layers"]["tail"][0]["ffn"]) == set(dict(ffn.named_children()))
    assert model.head.shape == (jcfg.d_model, jcfg.vocab_padded)
    assert model.layers[0].attn.wq.d_out == jcfg.n_heads * FRONTENDS[arch][2]


@pytest.mark.parametrize("fmt", ["packed", "int8"])
@pytest.mark.parametrize("das", [True, False], ids=["das", "dense"])
def test_mlp_ffn_matches_jax(pairs, rng, das, fmt):
    """musicgen-medium's 2-matrix MLP, w_out(gelu(w_in x)), on 13 residual
    rows with a random norm scale: the port's ``ffn_apply`` (the norm inside
    the DAS step) against the JAX package's on rmsnorm(scale, x), within
    1e-5."""
    jcfg, sparams, model = pairs("musicgen-medium", das=das, fmt=fmt)
    jp = sparams["layers"]["tail"][0]["ffn"]
    x = rng.standard_normal((1, 13, jcfg.d_model)).astype(np.float32)
    scale = (rng.standard_normal(jcfg.d_model) * 0.3).astype(np.float32)
    want = JT.ffn_apply(jp, jcfg, JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)))
    got = T.ffn_apply(model.layers[0].ffn, model.cfg, to_torch(x), to_torch(scale))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("serve_sparse", [True, False], ids=["lpsa", "full"])
@pytest.mark.parametrize("das", [True, False], ids=["das", "dense"])
@pytest.mark.parametrize("arch", sorted(FRONTENDS))
def test_embeds_prefill_and_forced_decode_match_jax(pairs, ties, arch, das, serve_sparse):
    jcfg, sparams, model = pairs(arch, das=das)
    chunk = jcfg.lpsa.chunk
    prompts = embed_prompts(jcfg.d_model, [2 * chunk + n for n in TAILS])
    assert_close(forced_teacher(jcfg, sparams, model, prompts, 2 * chunk,
                                serve_sparse=serve_sparse, ties=ties), ties)


@pytest.mark.parametrize("arch", sorted(FRONTENDS))
def test_int8_trits_from_embeds_match_jax(pairs, ties, arch):
    """The int8-resident serve format (das_gemv on every projection), DAS
    and LPSA on."""
    jcfg, sparams, model = pairs(arch, fmt="int8")
    assert model.layers[0].ffn.w_in.trits.dtype == torch.int8
    chunk = jcfg.lpsa.chunk
    prompts = embed_prompts(jcfg.d_model, [2 * chunk + n for n in TAILS], seed=2)
    assert_close(forced_teacher(jcfg, sparams, model, prompts, 2 * chunk, ties=ties), ties)


def test_decode_input_is_forced_row_or_token_embedding(pairs, monkeypatch):
    """A decode step's input: the forced row where ``forced`` is set, else
    the token's embedding in float32; without ``forced``, the embeddings of
    the ids in the model's dtype (the JAX package's ``decode_step``)."""
    _, _, model = pairs("pixtral-12b")
    cfg = model.cfg
    fx = torch.from_numpy(embed_prompts(cfg.d_model, [2], seed=4)[0])
    tok = torch.tensor([7, 9])
    seen, orig = [], T.stack_decode

    def spy(layers, cfg_, x, *a, **k):
        seen.append(x.clone())
        return orig(layers, cfg_, x, *a, **k)

    monkeypatch.setattr(T, "stack_decode", spy)
    caches = MD.init_caches(cfg, 2, 8, device="cpu")
    MD.decode_step(model, caches, tok, torch.tensor([0, 0]),
                   forced=torch.tensor([True, False]), forced_x=fx)
    MD.decode_step(model, caches, tok, torch.tensor([1, 1]))
    assert torch.equal(seen[0][0, 0], fx[0])
    assert torch.equal(seen[0][1, 0], model.embed[9].float())
    assert torch.equal(seen[1][:, 0], model.embed[tok])
