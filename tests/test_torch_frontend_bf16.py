"""The stub-frontend models under ``dtype="bfloat16"`` against the JAX
package: a float32 residual stream over bfloat16 weights and caches.

The embeddings arrive as float32 and every module returns x's dtype, so
both packages run the stream in float32 under a bfloat16 config; the norm
scales, embeddings and head stay bfloat16 (the head upcast, exactly, for
the logits), the weights ternary.  A prefill returns float32 K/V; the
engine's slot caches are bfloat16, the prefill's K/V rounded into them at
admission and every decode write rounded into the ring, whose rows the
float32 queries then read.

Reduced musicgen-medium and pixtral-12b (tests/test_torch_frontend.py's
configs, DAS and LPSA on): the prefill's K/V dtype on both sides, then the
prompts' pack-aligned 32 rows prefilled at B = 2, the caches rounded to
bfloat16 as the JAX engine's ``_insert_fn`` rounds them: the float32 K/V
within 1e-5 of the JAX package's (sums in another order: up to 9.5e-7
seen) and the port's rounding of them bitwise ``astype(bfloat16)`` (the
rounded rings themselves are not compared bitwise: a float32 ulp can cross a
rounding midpoint, as 1 of musicgen's 8192 layer-0 K values does).  Then
10 decode steps mixing forced rows and token ids through the bfloat16
rings: logits within 2e-4 and equal greedy tokens against the jitted JAX
package (a float32 stream: XLA's skipped bfloat16 roundings do not arise;
a step at a DAS near tie within 1e-2, as in tests/test_torch_frontend.py).
Then both
engines on tests/test_torch_frontend_engine.py's trace: bfloat16 slot
caches and the JAX engine's tokens and vtimes.
"""
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
from repro_torch.models import model as MD
from repro_torch.serve import Request, ServeConfig, ServeEngine
from test_torch_frontend import (FRONTENDS, TAILS, NearTies, assert_close, embed_prompts,
                                 frontend_pair)
from test_torch_frontend_engine import _trace
from test_torch_hybrid import one_thread  # noqa: F401

STEPS = 10


@pytest.mark.parametrize("arch", sorted(FRONTENDS))
def test_bf16_config_float32_stream_matches_jax(arch, monkeypatch):
    jcfg, sparams, model = frontend_pair(arch, dtype="bfloat16")
    assert model.embed.dtype == model.head.dtype == torch.bfloat16
    chunk, b, d = jcfg.lpsa.chunk, len(TAILS), jcfg.d_model
    prompts = embed_prompts(d, [2 * chunk + n for n in TAILS])
    head = np.stack([p[:2 * chunk] for p in prompts])
    rt, max_len = Runtime(), 2 * chunk + STEPS + max(TAILS)
    jlg, jc = jax.jit(lambda sp, x: JMD.prefill(sp, jcfg, x, rt, max_len=max_len))(
        sparams, jnp.asarray(head))
    tlg, tc = MD.prefill(model, torch.from_numpy(head), max_len=max_len)
    assert all(l["k"].dtype == jnp.float32 for l in jc["tail"])
    assert all(c["k"].dtype == torch.float32 for c in tc)
    # into bfloat16 rings, rounded as the JAX engine's _insert_fn rounds
    j32, jc = jc, jax.tree.map(
        lambda a: a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a, jc)
    t32, tc = tc, [{k: v.to(torch.bfloat16) if v.is_floating_point() else v
                    for k, v in c.items()} for c in tc]
    for jl, tl, tl32 in zip(j32["tail"], tc, t32):
        for key in ("k", "v"):
            np.testing.assert_allclose(tl32[key].numpy(), np.asarray(jl[key]),
                                       rtol=0, atol=1e-5)
            want = np.asarray(jnp.asarray(tl32[key].numpy()).astype(jnp.bfloat16))
            np.testing.assert_array_equal(tl[key].float().numpy(), want.astype(np.float32))
    ties = NearTies(monkeypatch)
    ties.step()

    def jstep(sp, c, tok, t, forced, fx):
        x = jnp.take(sp["embed"], tok, axis=0).astype(jnp.float32)
        x = jnp.where(forced[:, None], fx, x)[:, None, :]
        return JMD.decode_step(sp, jcfg, c, x, t, rt)

    jdecode = jax.jit(jstep)
    logits = [(np.asarray(jlg), tlg.numpy())]
    for i in range(STEPS):
        t = 2 * chunk + i
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
        ties.step()
        tlg, tc = MD.decode_step(model, tc, torch.from_numpy(tok).long(), torch.full((b,), t),
                                 forced=torch.from_numpy(forced), forced_x=torch.from_numpy(fx))
        assert tlg.dtype == torch.float32 and all(c["k"].dtype == torch.bfloat16 for c in tc)
        logits.append((np.asarray(jlg), tlg.numpy()))
    assert_close(logits, ties)
    for jl, tl in zip(jc["tail"], tc):     # the decode writes rounded alike
        np.testing.assert_array_equal(tl["pos"].numpy(), np.asarray(jl["pos"]))


@pytest.mark.parametrize("arch", sorted(FRONTENDS))
def test_bf16_engine_matches_jax(arch):
    """Both engines on the probe trace: bfloat16 slot caches, equal tokens,
    first-token and finish vtimes and prefill tokens."""
    jcfg, sparams, model = frontend_pair(arch, dtype="bfloat16")
    kw = dict(max_slots=2, max_len=64)
    jeng = JServeEngine(jcfg, sparams, Runtime(), config=JServeConfig(kernel_mode="ref", **kw))
    eng = ServeEngine(model, ServeConfig(**kw), device="cpu")
    assert all(c["k"].dtype == torch.bfloat16 for c in eng.caches)
    assert all(l["k"].dtype == jnp.bfloat16 for l in jeng.caches["tail"])
    runs = []
    for e, cls in ((jeng, JRequest), (eng, Request)):
        for r in _trace(jcfg.d_model, cls):
            e.submit(r)
        runs.append(e.run())
    want, got = runs
    for uid in want:
        np.testing.assert_array_equal(got[uid].tokens, want[uid].tokens,
                                      err_msg=f"request {uid}")
        assert got[uid].first_token_vtime == want[uid].first_token_vtime
        assert got[uid].finish_vtime == want[uid].finish_vtime
    assert eng.stats.prefill_tokens == jeng.stats.prefill_tokens == 32
