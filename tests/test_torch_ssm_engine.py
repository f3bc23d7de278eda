"""The SSM pair through the port's engine against the JAX package's.

Reduced rwkv6-3b and gla-1.3b (tests/test_torch_ssm.py::ssm_pair) on a
greedy staggered trace: prompts of 64, 61 and the first 64 again, arriving
at vtimes 0, 1 and 8, 6 new tokens each, 2 slots, ``max_len=32``.  The
prompts are longer than ``max_len``: an engine without attention layers
keeps O(1) recurrent state a slot and accepts them, as the JAX engine does,
prefilling each whole prompt at admission.  Tokens, first-token and finish
vtimes and ``prefill_tokens`` equal the JAX engine's, with the per-slot
layout and under ``layout="paged"`` (no page arena: the prefix trie shares
exact recurrent states, 1 hit and 125 of 189 prefill tokens); the resolved
slot-state union (``layout_summary``); joint against solo batch invariance;
the states written in place and scrubbed at retirement; the CLI.
"""
import numpy as np
import pytest
import torch

from repro.models.transformer import Runtime
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch.launch import serve as cli
from repro_torch.models import model as MD
from repro_torch.serve import Request, ServeConfig, ServeEngine
from test_torch_ssm import ARCHS, ssm_pair

LAYOUTS = {"dense": dict(max_slots=2, max_len=32),
           "paged": dict(max_slots=2, max_len=32, layout="paged", page_size=16)}


def _trace(vocab, request_cls):
    rng = np.random.default_rng(3)
    p0, p1 = rng.integers(0, vocab, 64), rng.integers(0, vocab, 61)
    return [request_cls(uid=0, prompt=p0, max_new_tokens=6, arrival=0),
            request_cls(uid=1, prompt=p1, max_new_tokens=6, arrival=1),
            request_cls(uid=2, prompt=p0.copy(), max_new_tokens=6, arrival=8)]


@pytest.fixture(scope="module")
def served():
    """(JAX engine, its results, port engine, its results) per (arch,
    layout), each run once."""
    cache, pairs = {}, {}

    def get(arch, layout):
        if (arch, layout) not in cache:
            if arch not in pairs:
                pairs[arch] = ssm_pair(arch)
            jcfg, sparams, model = pairs[arch]
            kw = LAYOUTS[layout]
            jeng = JServeEngine(jcfg, sparams, Runtime(),
                                config=JServeConfig(kernel_mode="ref", **kw))
            eng = ServeEngine(model, ServeConfig(**kw), device="cpu")
            runs = []
            for e, cls in ((jeng, JRequest), (eng, Request)):
                for r in _trace(jcfg.vocab, cls):
                    e.submit(r)
                runs.append(e.run())
            cache[arch, layout] = jeng, runs[0], eng, runs[1]
        return cache[arch, layout]
    return get


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_engine_matches_jax(served, arch, layout):
    jeng, want, eng, got = served(arch, layout)
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for uid in want:
        np.testing.assert_array_equal(got[uid].tokens, want[uid].tokens,
                                      err_msg=f"request {uid}")
        assert got[uid].first_token_vtime == want[uid].first_token_vtime
        assert got[uid].finish_vtime == want[uid].finish_vtime
    assert eng.stats.prefill_tokens == jeng.stats.prefill_tokens
    assert eng.stats.prefix_hits == jeng.stats.prefix_hits
    assert (eng.stats.prefill_tokens, eng.stats.prefix_hits) == (
        (125, 1) if layout == "paged" else (189, 0))
    assert eng.pool_stats()["pages_in_use"] == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_layout_summary_matches_jax(served, arch):
    """Every layer's slot state is its kind's recurrent layout, as the JAX
    engine resolves it, under both layouts."""
    for layout in LAYOUTS:
        jeng, _, eng, _ = served(arch, layout)
        assert eng.layout_summary() == jeng.layout_summary()
        kind = eng.cfg.layer_pattern[0]
        assert {(d["kind"], d["layout"]) for d in eng.layout_summary()} == {(kind, kind)}


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_engine_batch_invariance(served, arch):
    """A request re-served alone gives the tokens it got beside another
    (joint against solo).  Retiring it scrubs its slot (slot 0, retired in
    the run's last tick; an idle row's states advance every tick, as in the
    JAX engine, and admission overwrites all of them)."""
    _, _, eng, got = served(arch, "dense")
    for uid in (0, 1):
        r = _trace(eng.cfg.vocab, Request)[uid]
        eng.submit(Request(uid=10 + uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens))
        np.testing.assert_array_equal(eng.run()[10 + uid].tokens, got[uid].tokens)
        for cache in eng.caches:
            for key, buf in cache.items():
                assert buf.dtype == torch.float32 and not buf[0].any(), key


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_decode_writes_states_in_place(arch):
    """A decode step updates every recurrent state in its own storage (the
    CUDA graph holds it), and the prompt + generation may exceed max_len."""
    jcfg, _, model = ssm_pair(arch)
    tok = torch.from_numpy(np.random.default_rng(2).integers(0, jcfg.vocab, 40))[None]
    _, caches = MD.prefill(model, tok)
    before = [{k: (v.data_ptr(), v.clone()) for k, v in c.items()} for c in caches]
    MD.decode_step(model, caches, torch.tensor([5]), torch.tensor([40]))
    for c, b in zip(caches, before):
        for key, (ptr, old) in b.items():
            assert c[key].data_ptr() == ptr and not torch.equal(c[key], old), key
    eng = ServeEngine(model, ServeConfig(max_slots=2, max_len=8), device="cpu")
    eng.validate(Request(uid=0, prompt=np.arange(40), max_new_tokens=30))


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_ssm_reduced_on_cpu(capsys, arch):
    res = cli.main(["--arch", arch, "--reduced", "--device", "cpu", "--requests", "2",
                    "--prompt-len", "20", "--gen", "3", "--slots", "2", "--stagger", "1"])
    assert sorted(res) == [0, 1] and all(len(r.tokens) == 3 for r in res.values())
    assert f"{arch}-smoke" in capsys.readouterr().out
