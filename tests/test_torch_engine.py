"""The port's ServeEngine against the JAX package's, and its own contracts.

Greedy tokens of a staggered 3-request trace (pack-aligned prefix + tail,
one whole pack, tail only; 2 slots, so one request queues) must equal the
JAX engine's on both configs of test_torch_model.py, on the same weights.
Then batch invariance, EOS retirement, request validation and the CLI.
"""
import numpy as np
import pytest

from repro.models.transformer import Runtime
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch.launch import serve as cli
from repro_torch.serve import Request, ServeConfig, ServeEngine
from test_torch_model import CONFIGS, jax_and_port


def _trace(cfg, request_cls, seed=0):
    c = cfg.lpsa.chunk if cfg.lpsa else 16
    rng = np.random.default_rng(seed)
    spec = [(2 * c + c // 2, 6, 0), (c, 6, 1), (c // 2 + 1, 6, 3)]
    return [request_cls(uid=i, prompt=rng.integers(0, cfg.vocab, p).astype(np.int32),
                        max_new_tokens=g, arrival=a)
            for i, (p, g, a) in enumerate(spec)]


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def served(request):
    """(port cfg, port model, port results, jax results, (jax cfg, jax
    serving params, jax kernel mode)) for one config."""
    jcfg, sparams, tcfg, model, mode = jax_and_port(request.param)
    jeng = JServeEngine(jcfg, sparams, Runtime(),
                        config=JServeConfig(max_slots=2, max_len=64, kernel_mode=mode))
    for r in _trace(jcfg, JRequest):
        jeng.submit(r)
    jres = jeng.run()
    eng = ServeEngine(model, ServeConfig(max_slots=2, max_len=64), device="cpu")
    for r in _trace(tcfg, Request):
        eng.submit(r)
    return tcfg, model, eng.run(), jres, (jcfg, sparams, mode)


def test_engine_tokens_match_jax(served):
    _, _, got, want, _ = served
    assert sorted(got) == sorted(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid].tokens, want[uid].tokens,
                                      err_msg=f"request {uid}")
        assert got[uid].first_token_vtime == want[uid].first_token_vtime
        assert got[uid].finish_vtime == want[uid].finish_vtime


def test_engine_batch_invariance(served):
    tcfg, model, batched, _, _ = served
    eng = ServeEngine(model, ServeConfig(max_slots=2, max_len=64), device="cpu")
    for r in _trace(tcfg, Request):
        if r.uid != 1:
            continue
        eng.submit(Request(uid=7, prompt=r.prompt, max_new_tokens=r.max_new_tokens))
    alone = eng.run()[7].tokens
    np.testing.assert_array_equal(alone, batched[1].tokens)


def test_engine_eos_frees_slot(served):
    """EOS = a token whose first occurrence in the free run is at index >= 2,
    so an earlier copy of the same id cannot end the run first."""
    tcfg, model, _, _, _ = served
    eng = ServeEngine(model, ServeConfig(max_slots=1, max_len=64), device="cpu")
    for seed in range(16):
        prompt = np.random.default_rng(100 + seed).integers(0, tcfg.vocab, 5)
        eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=12))
        free = eng.run()[0].tokens.tolist()
        first = {}
        for i, tok in enumerate(free):
            first.setdefault(tok, i)
        idx = min((i for i in first.values() if i >= 2), default=None)
        if idx is not None:
            break
    assert idx is not None, "no free run with a fresh token at index >= 2"
    eng.submit(Request(uid=1, prompt=prompt, max_new_tokens=12, eos_id=free[idx]))
    eng.submit(Request(uid=2, prompt=prompt, max_new_tokens=3, arrival=1))
    res = eng.run()
    assert res[1].tokens.tolist() == free[:idx + 1]
    assert res[2].tokens.tolist() == free[:3]       # the freed slot serves the next
    assert eng.num_active == 0


def test_engine_rejects_what_it_cannot_serve(served):
    """A request at temperature 0.7 is served, its tokens the JAX engine's
    (the same uid and seed); bad prompts, lengths and uids raise."""
    tcfg, model, _, _, (jcfg, sparams, mode) = served
    prompt = np.arange(4, dtype=np.int32)
    jeng = JServeEngine(jcfg, sparams, Runtime(),
                        config=JServeConfig(max_slots=1, max_len=16, kernel_mode=mode))
    jeng.submit(JRequest(uid=0, prompt=prompt, max_new_tokens=6, temperature=0.7))
    eng = ServeEngine(model, ServeConfig(max_slots=1, max_len=16), device="cpu")
    eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=6, temperature=0.7))
    np.testing.assert_array_equal(eng.run()[0].tokens, jeng.run()[0].tokens)
    with pytest.raises(ValueError, match="int32"):
        eng.submit(Request(uid=2 ** 31, prompt=prompt, max_new_tokens=2))
    with pytest.raises(ValueError):
        eng.submit(Request(uid=0, prompt=np.array([0, tcfg.vocab]), max_new_tokens=2))
    with pytest.raises(ValueError):
        eng.submit(Request(uid=0, prompt=np.arange(4), max_new_tokens=0))
    full = ServeEngine(model, ServeConfig(max_slots=1, max_len=16), device="cpu",
                       serve_sparse=False)
    with pytest.raises(ValueError, match="max_len"):
        full.submit(Request(uid=0, prompt=np.arange(10), max_new_tokens=8))


def test_cli_reduced_on_cpu(capsys):
    res = cli.main(["--arch", "bitnet-1.3b", "--reduced", "--device", "cpu",
                    "--requests", "3", "--prompt-len", "20", "--gen", "4",
                    "--slots", "2", "--stagger", "1"])
    assert sorted(res) == [0, 1, 2]
    assert all(len(r.tokens) == 4 for r in res.values())
    assert "decode steps" in capsys.readouterr().out
    with pytest.raises(SystemExit):   # an id no registry has: get_config raises
        cli.main(["--arch", "no-such-arch", "--device", "cpu"])


@pytest.mark.parametrize("name", ["bitnet-reduced-int8", "baseline-reduced"])
def test_trits_engine_tokens_match_jax(name):
    """The int8-resident formats through the engine: tokens and virtual
    times equal the JAX engine's on the staggered trace.  The baseline has
    no LPSA, so every global layer keeps a full cache and a prompt prefills
    whole at admission."""
    jcfg, sparams, tcfg, model, mode = jax_and_port(name)
    jeng = JServeEngine(jcfg, sparams, Runtime(),
                        config=JServeConfig(max_slots=2, max_len=64, kernel_mode=mode))
    for r in _trace(jcfg, JRequest):
        jeng.submit(r)
    want = jeng.run()
    eng = ServeEngine(model, ServeConfig(max_slots=2, max_len=64), device="cpu")
    for r in _trace(tcfg, Request):
        eng.submit(r)
    got = eng.run()
    assert sorted(got) == sorted(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid].tokens, want[uid].tokens,
                                      err_msg=f"request {uid}")
        assert got[uid].first_token_vtime == want[uid].first_token_vtime
        assert got[uid].finish_vtime == want[uid].finish_vtime
    if tcfg.lpsa is None:   # whole-prompt prefill into full caches
        assert eng.stats.prefill_tokens == sum(len(r.prompt) for r in _trace(tcfg, Request))
        assert all(c["k"].shape[1] == 64 for c in eng.caches)
