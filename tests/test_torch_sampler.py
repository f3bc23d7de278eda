"""The port's sampler against ``jax.random`` and the JAX package's sampler.

Keys (``PRNGKey`` + two ``fold_in``), random bits and uniforms are integer
and bit work and must equal JAX's bitwise.  Gumbel noise takes two logs,
XLA's CPU log on one side and torch's on the other: measured here, they
differ by at most 1 float32 ulp, which leaves the noise within 2 ulps of
max(|g|, 1) (1.81 measured).  ``sample_token`` must pick JAX's token
wherever the top two perturbed scores differ by more than ``MARGIN``; rows
inside it are counted as near ties.  Then the engine: tokens, virtual times
and results equal ``repro``'s ``ServeEngine`` on tests/test_serve_engine.py's
temperature trace (tiny dense config, ring and full caches, per-slot and
paged) and on reduced musicgen-medium's embedding prompts, and a request
served alone gives the tokens it got beside the others.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JMD
from repro.models.transformer import Runtime
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve.sampler import make_sampler as jmake_sampler
from repro_torch.bridge import load_serving_tree
from repro_torch.configs import base as tbase
from repro_torch.serve import Request, ServeConfig, ServeEngine
from repro_torch.serve import sampler as S
from test_serve_engine import CFG as JCFG
from test_serve_engine import _trace as temperature_trace
from test_torch_frontend import embed_prompts, frontend_pair
from test_torch_hybrid import one_thread  # noqa: F401

SEEDS, UIDS, COUNTERS = (0, 1, 2 ** 31 - 1), (0, 1, 7, 2 ** 31 - 1), (0, 1, 31)
EPS = float(np.finfo(np.float32).eps)
TINY = float(np.finfo(np.float32).tiny)
MARGIN = 1e-5     # > 2 ulps of the largest |gumbel| (~16) on either side


def _jax_keys(seed):
    base = jax.random.PRNGKey(seed)
    return [jax.random.fold_in(jax.random.fold_in(base, jnp.int32(u)), jnp.int32(c))
            for u in UIDS for c in COUNTERS]


def _port_keys(seed):
    uids = torch.tensor([u for u in UIDS for _ in COUNTERS])
    ctrs = torch.tensor([c for _ in UIDS for c in COUNTERS])
    return S.fold_keys(S.prng_key(seed), uids, ctrs)


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("width", [256, 32000])
@pytest.mark.parametrize("seed", SEEDS)
def test_keys_bits_uniforms_match_jax(seed, width):
    jbits = jax.jit(lambda k: jax.random.bits(k, (width,)))
    junif = jax.jit(lambda k: jax.random.uniform(k, (width,), minval=TINY))
    keys = _port_keys(seed)
    bits, unif = S.random_bits(keys, width), S.uniform(keys, width)
    for i, jk in enumerate(_jax_keys(seed)):
        np.testing.assert_array_equal(keys[i].numpy(), np.asarray(jk).astype(np.int64))
        np.testing.assert_array_equal(bits[i].numpy(), np.asarray(jbits(jk)).astype(np.int64))
        np.testing.assert_array_equal(unif[i].numpy().view(np.int32),
                                      np.asarray(junif(jk)).view(np.int32))


@pytest.mark.parametrize("width", [256, 32000])
def test_gumbel_within_the_ulps_of_xla_log(width):
    """XLA's CPU log and torch's differ by at most 1 ulp on the uniforms and
    on -log(u); the noise is then within 2 ulps of max(|g|, 1)."""
    jlog = jax.jit(jnp.log)
    jgum = jax.jit(lambda k: jax.random.gumbel(k, (width,)))
    keys, worst = _port_keys(1), 0.0
    u = S.uniform(keys, width)
    for x in (u, -torch.log(u)):
        assert _ulps(np.asarray(jlog(jnp.asarray(x.numpy()))), torch.log(x).numpy()).max() <= 1
    g = S.gumbel(keys, width).numpy()
    for i, jk in enumerate(_jax_keys(1)):
        want = np.asarray(jgum(jk))
        worst = max(worst, float((np.abs(g[i] - want) / np.maximum(np.abs(want), 1)).max()))
    assert worst <= 2 * EPS, worst / EPS


@pytest.mark.parametrize("top_k", [0, 4])
@pytest.mark.parametrize("temp", [0.0, 0.5, 0.9, 5.0])
def test_sample_token_matches_jitted_jax(temp, top_k):
    """1200 seeded rows of 256 logits (the last 16 padded at -1e30, as the
    models pad the vocabulary): JAX's jitted batched sampler and the port's
    pick the same token in every row whose two best perturbed scores lie
    more than MARGIN apart; the rest are near ties, counted."""
    rows, width = 1200, 256
    rng = np.random.default_rng(int(temp * 10) + top_k)
    logits = (rng.standard_normal((rows, width)) * 2).astype(np.float32)
    logits[:, -16:] = -1e30
    uids = np.arange(rows, dtype=np.int32) * 7919
    ctrs = np.arange(rows, dtype=np.int32) % 31
    temps = np.full(rows, temp, np.float32)
    base = jax.random.PRNGKey(3)
    jkeys = jax.vmap(lambda u, c: jax.random.fold_in(jax.random.fold_in(base, u), c))(
        jnp.asarray(uids), jnp.asarray(ctrs))
    want = np.asarray(jax.jit(jmake_sampler(top_k))(jnp.asarray(logits), jkeys,
                                                    jnp.asarray(temps)))
    tkeys = S.fold_keys(S.prng_key(3), torch.from_numpy(uids), torch.from_numpy(ctrs))
    np.testing.assert_array_equal(tkeys.numpy(), np.asarray(jkeys).astype(np.int64))
    lg = torch.from_numpy(logits)
    got = S.make_sampler(top_k)(lg, tkeys, torch.from_numpy(temps)).numpy()
    if temp == 0:
        np.testing.assert_array_equal(got, want)
        return
    masked = lg if not top_k else torch.where(
        lg >= torch.topk(lg, top_k).values[:, -1:], lg, float("-inf"))
    score = (S.gumbel(tkeys, width) + masked / temp).sort(-1, descending=True).values
    near = (score[:, 0] - score[:, 1] <= MARGIN).numpy()
    print(f"T={temp} top_k={top_k}: {near.sum()} near ties of {rows} rows")
    np.testing.assert_array_equal(got[~near], want[~near])
    assert near.sum() <= rows // 100
    if top_k:
        assert (np.take_along_axis(logits, got[:, None], 1)[:, 0]
                >= np.sort(logits, 1)[:, -top_k]).all()


# --------------------------------------------------------------------------
# the engine, sampling
# --------------------------------------------------------------------------

def _tcfg(jcfg):
    """The JAX test config's twin in the port's schema."""
    j = dataclasses.asdict(jcfg)
    tern = dict(j.pop("ternary"))
    das = tern.pop("das")
    lpsa = j.pop("lpsa")
    return tbase.ModelConfig(
        **j, lpsa=tbase.LpsaConfig(**lpsa),
        ternary=tbase.TernaryConfig(**tern, das=tbase.DasConfig(**das)))


@pytest.fixture(scope="module")
def tiny():
    sparams = JMD.export_serving(JMD.init_params(jax.random.PRNGKey(0), JCFG), JCFG)
    tcfg = _tcfg(JCFG)
    return sparams, load_serving_tree(jax.tree.map(np.asarray, sparams), tcfg, "cpu")


def _port_request(r, **kw) -> Request:
    return Request(**{**{f.name: getattr(r, f.name) for f in dataclasses.fields(Request)},
                      **kw})


def _same_results(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for uid, w in want.items():
        g = got[uid]
        np.testing.assert_array_equal(g.tokens, w.tokens, err_msg=f"request {uid}")
        for f in ("prompt_len", "arrival", "admit_vtime", "first_token_vtime",
                  "finish_vtime", "admitted_with_active", "slo_steps", "preempted",
                  "queue_wait_steps", "slo_met"):
            assert getattr(g, f) == getattr(w, f), (uid, f)


LAYOUTS = {"dense": {}, "paged": dict(layout="paged", page_size=16)}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("sparse", [True, False], ids=["ring", "full"])
def test_engine_sampling_matches_jax(tiny, sparse, layout):
    sparams, model = tiny
    kw = dict(max_slots=2, max_len=64, seed=0, **LAYOUTS[layout])
    trace = temperature_trace()
    jeng = JServeEngine(JCFG, sparams, Runtime(serve_sparse=sparse),
                        config=JServeConfig(**kw))
    eng = ServeEngine(model, ServeConfig(**kw), device="cpu", serve_sparse=sparse)
    for r in trace:
        jeng.submit(r)
        eng.submit(_port_request(r))
    want, got = jeng.run(), eng.run()
    _same_results(got, want)
    assert eng.stats.decode_steps == jeng.stats.decode_steps
    assert eng.stats.sampling_steps > 0
    for r in trace:     # alone, on a fresh engine: the tokens it got beside the others
        solo = ServeEngine(model, ServeConfig(**kw), device="cpu", serve_sparse=sparse)
        solo.submit(_port_request(r, arrival=0))
        np.testing.assert_array_equal(solo.run()[r.uid].tokens, got[r.uid].tokens)


def test_engine_sampling_embedding_prompts_match_jax():
    """Reduced musicgen-medium from float32 embedding prompts (the forced
    rows), at temperatures 0.9, 0 and 0.8; the 16-row prompt is one whole
    pack, so its first token is sampled from the prefill's logits."""
    jcfg, sparams, model = frontend_pair("musicgen-medium")
    prompts = embed_prompts(jcfg.d_model, (18, 23, 16), seed=3)
    spec = [(8, 0, 0.9), (6, 2, 0.0), (7, 4, 0.8)]
    kw = dict(max_slots=2, max_len=64, seed=5)
    jeng = JServeEngine(jcfg, sparams, Runtime(), config=JServeConfig(kernel_mode="ref", **kw))
    eng = ServeEngine(model, ServeConfig(**kw), device="cpu")
    for i, (p, (g, a, t)) in enumerate(zip(prompts, spec)):
        jeng.submit(JRequest(uid=i, prompt=p, max_new_tokens=g, arrival=a, temperature=t))
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=g, arrival=a, temperature=t))
    _same_results(eng.run(), jeng.run())
    assert eng.stats.sampling_steps > 0
