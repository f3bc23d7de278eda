"""The stub-frontend models through the port's engine against the JAX
package's, and the CLI.

Reduced musicgen-medium and pixtral-12b (tests/test_torch_frontend.py's
configs, float32) on a greedy staggered trace of embedding prompts: 18, 23
and 10 rows arriving at vtimes 0, 2 and 4, with 8, 6 and 7 new tokens, 2
slots, ``max_len=64``.  The attention layers stream (LPSA, packs of 16), so
admission prefills the pack-aligned prefix (16, 16 and no rows: 32 prefill
tokens) and feeds the tail a row a tick through ``forced_x``.  Tokens,
first-token and finish vtimes, ``prefill_tokens`` and ``prefix_hits`` (0:
embeddings carry no ids to key the trie on) equal the JAX engine's, with
the per-slot layout and under ``layout="paged"``.  Also: the slot-state
layouts (a ring on every layer), joint against solo batch invariance,
``validate`` refusing a prompt of the wrong kind, ``Request.prompt_len`` of
a 2-D prompt, and the CLI on both archs.
"""
import numpy as np
import pytest

from repro.models.transformer import Runtime
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_config, reduced
from repro_torch.launch import serve as cli
from repro_torch.models import model as MD
from repro_torch.serve import Request, ServeConfig, ServeEngine
from test_torch_frontend import FRONTENDS, embed_prompts, frontend_pair
from test_torch_hybrid import one_thread  # noqa: F401

LAYOUTS = {"dense": dict(max_slots=2, max_len=64),
           "paged": dict(max_slots=2, max_len=64, layout="paged", page_size=16)}
PROMPT_ROWS, GEN, ARRIVALS = (18, 23, 10), (8, 6, 7), (0, 2, 4)


def _trace(d_model, request_cls):
    prompts = embed_prompts(d_model, PROMPT_ROWS, seed=3)
    return [request_cls(uid=i, prompt=p, max_new_tokens=g, arrival=a)
            for i, (p, g, a) in enumerate(zip(prompts, GEN, ARRIVALS))]


@pytest.fixture(scope="module")
def served():
    """(JAX engine, its results, port engine, its results) per (arch,
    layout), each run once."""
    cache, pairs = {}, {}

    def get(arch, layout):
        if (arch, layout) not in cache:
            if arch not in pairs:
                pairs[arch] = frontend_pair(arch)
            jcfg, sparams, model = pairs[arch]
            kw = LAYOUTS[layout]
            jeng = JServeEngine(jcfg, sparams, Runtime(),
                                config=JServeConfig(kernel_mode="ref", **kw))
            eng = ServeEngine(model, ServeConfig(**kw), device="cpu")
            runs = []
            for e, cls in ((jeng, JRequest), (eng, Request)):
                for r in _trace(jcfg.d_model, cls):
                    e.submit(r)
                runs.append(e.run())
            cache[arch, layout] = (jeng, runs[0], eng, runs[1])
        return cache[arch, layout]
    return get


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("arch", sorted(FRONTENDS))
def test_frontend_engine_matches_jax(served, arch, layout):
    jeng, want, eng, got = served(arch, layout)
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for uid in want:
        np.testing.assert_array_equal(got[uid].tokens, want[uid].tokens,
                                      err_msg=f"request {uid}")
        assert got[uid].first_token_vtime == want[uid].first_token_vtime
        assert got[uid].finish_vtime == want[uid].finish_vtime
        assert got[uid].prompt_len == PROMPT_ROWS[uid]
    assert eng.stats.prefill_tokens == jeng.stats.prefill_tokens == 32
    assert eng.stats.prefix_hits == jeng.stats.prefix_hits == 0
    assert eng.stats.decode_steps == jeng.stats.decode_steps
    assert eng.layout_summary() == jeng.layout_summary()
    assert {d["layout"] for d in eng.layout_summary()} == {"ring"}
    if layout == "paged":
        assert eng._radix is None and eng.pool_stats()["prefix_entries"] == 0


@pytest.mark.parametrize("arch", sorted(FRONTENDS))
def test_frontend_engine_batch_invariance(served, arch):
    """Each request re-served alone on the same engine gives the tokens it
    got beside the others, bit for bit; the forced rows are cleared between
    requests."""
    _, _, eng, batched = served(arch, "dense")
    for r in _trace(eng.cfg.d_model, Request):
        eng.submit(Request(uid=10 + r.uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens))
        alone = eng.run()[10 + r.uid]
        assert alone.tokens.tolist() == batched[r.uid].tokens.tolist(), r.uid
    assert all(s.input_x is None for s in eng._slots)


def test_validate_refuses_the_other_prompt_kind():
    """An embeddings config refuses token ids and rows of the wrong width;
    a token config refuses embeddings."""
    emb = ServeEngine(MD.init_serving(reduced(get_config("musicgen-medium")), device="cpu"),
                      ServeConfig(max_slots=1, max_len=32), device="cpu")
    d = emb.cfg.d_model
    with pytest.raises(ValueError, match="float embeddings"):
        emb.submit(Request(uid=0, prompt=np.arange(4), max_new_tokens=2))
    with pytest.raises(ValueError, match="float embeddings"):
        emb.submit(Request(uid=0, prompt=np.zeros((4, d + 1), np.float32), max_new_tokens=2))
    emb.submit(Request(uid=0, prompt=np.zeros((4, d), np.float32), max_new_tokens=2))
    tok = ServeEngine(MD.init_serving(reduced(get_config("bitnet-1.3b")), device="cpu"),
                      ServeConfig(max_slots=1, max_len=32), device="cpu")
    with pytest.raises(ValueError, match="token ids"):
        tok.submit(Request(uid=0, prompt=np.zeros((4, d), np.float32), max_new_tokens=2))


def test_request_prompt_len_of_embeddings():
    """A (P, D) prompt has P rows, as the JAX package's Request counts it."""
    p = np.zeros((23, 64), np.float32)
    assert Request(uid=0, prompt=p, max_new_tokens=1).prompt_len == 23
    assert JRequest(uid=0, prompt=p, max_new_tokens=1).prompt_len == 23


@pytest.mark.parametrize("arch", sorted(FRONTENDS))
def test_cli_serves_frontend_reduced_on_cpu(capsys, arch):
    """The CLI draws embedding prompts (as the JAX package's CLI does) and
    serves them; the tail rows go through the decode step."""
    res = cli.main(["--arch", arch, "--reduced", "--device", "cpu", "--requests", "3",
                    "--prompt-len", "20", "--gen", "4", "--slots", "2", "--stagger", "1"])
    assert sorted(res) == [0, 1, 2]
    assert all(len(r.tokens) == 4 and r.prompt_len == 20 for r in res.values())
    assert "decode steps" in capsys.readouterr().out
    prompt = cli.make_prompt(get_config(arch), np.random.default_rng(0), 3)
    assert prompt.dtype == np.float32 and prompt.shape == (3, get_config(arch).d_model)


def test_embeds_share_no_prefix():
    """``prefix_sharing`` stays on in the config, yet an embeddings engine
    builds no trie: its prompts have no ids to key on."""
    model = MD.init_serving(reduced(get_config("pixtral-12b")), device="cpu")
    eng = ServeEngine(model, ServeConfig(max_slots=1, max_len=64, layout="paged"),
                      device="cpu")
    assert eng.config.prefix_sharing and eng._radix is None
