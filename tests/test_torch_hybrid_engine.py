"""The hybrid zamba2 through the port's engine against the JAX package's.

Reduced zamba2-2.7b at 12 layers (tests/test_torch_hybrid.py::hybrid_pair,
scan-stacked on the JAX side: two groups of the 6-layer pattern, the shared
attention threaded through both) on a greedy staggered trace: prompts of
40, 37 and the first 40 again, arriving at vtimes 0, 1 and 8, 20 new tokens
each, 2 slots, ``max_len=32``.  The attention layers stream (LPSA), so admission prefills
the pack-aligned prefix (32 tokens) and feeds the tail a token a tick, and
prompt + generation may pass ``max_len``.  Tokens, first-token and finish
vtimes and ``prefill_tokens`` equal the JAX engine's, with the per-slot
layout (96 prefill tokens) and under ``layout="paged"`` (no page arena:
the trie shares the exact ring and mamba states, 1 hit and 64 prefill
tokens).  tests/test_paged_kv.py's ``CFG_HYBRID`` (a mamba layer and a
full-attention layer paged through the arena, chunk 8) on a greedy trace:
the JAX engine's tokens, every page back after retirement and the retired
slots' carries zero.  The slot-state union (``layout_summary``); joint
against solo batch invariance; the six mamba leaves carried by admission,
the prefix trie's snapshots and the retirement scrub; the CLI.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import model as JMD
from repro.models.transformer import Runtime
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch.bridge import load_serving_tree
from repro_torch.configs import base as tbase
from repro_torch.configs import get_config
from repro_torch.launch import serve as cli
from repro_torch.models import model as MD
from repro_torch.serve import Request, ServeConfig, ServeEngine
from test_torch_hybrid import hybrid_pair, one_thread  # noqa: F401

LAYOUTS = {"dense": dict(max_slots=2, max_len=32),
           "paged": dict(max_slots=2, max_len=32, layout="paged", page_size=16)}
MAMBA_KEYS = ["conv", "ssd_b", "ssd_c", "ssd_dt", "ssd_x", "ssm"]


def _trace(vocab, request_cls):
    rng = np.random.default_rng(3)
    p0, p1 = rng.integers(0, vocab, 40), rng.integers(0, vocab, 37)
    return [request_cls(uid=0, prompt=p0, max_new_tokens=20, arrival=0),
            request_cls(uid=1, prompt=p1, max_new_tokens=20, arrival=1),
            request_cls(uid=2, prompt=p0.copy(), max_new_tokens=20, arrival=8)]


def _run(jcfg, sparams, model, kw, trace_fn, rt=None, serve_sparse=True):
    """(JAX engine, its results, port engine, its results) on one trace."""
    jeng = JServeEngine(jcfg, sparams, rt or Runtime(),
                        config=JServeConfig(kernel_mode="ref", **kw))
    eng = ServeEngine(model, ServeConfig(**kw), device="cpu", serve_sparse=serve_sparse)
    runs = []
    for e, cls in ((jeng, JRequest), (eng, Request)):
        for r in trace_fn(cls):
            e.submit(r)
        runs.append(e.run())
    return jeng, runs[0], eng, runs[1]


@pytest.fixture(scope="module")
def served():
    """(JAX engine, its results, port engine, its results) per layout, each
    run once."""
    cache, pair = {}, []

    def get(layout):
        if layout not in cache:
            if not pair:
                pair.append(hybrid_pair(scan=True))
            jcfg, sparams, model = pair[0]
            cache[layout] = _run(jcfg, sparams, model, LAYOUTS[layout],
                                 lambda cls: _trace(jcfg.vocab, cls))
        return cache[layout]
    return get


def _same_results(want, got):
    assert sorted(got) == sorted(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid].tokens, want[uid].tokens,
                                      err_msg=f"request {uid}")
        assert got[uid].first_token_vtime == want[uid].first_token_vtime
        assert got[uid].finish_vtime == want[uid].finish_vtime


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_hybrid_engine_matches_jax(served, layout):
    jeng, want, eng, got = served(layout)
    _same_results(want, got)
    assert eng.stats.prefill_tokens == jeng.stats.prefill_tokens
    assert eng.stats.prefix_hits == jeng.stats.prefix_hits
    assert (eng.stats.prefill_tokens, eng.stats.prefix_hits) == (
        (64, 1) if layout == "paged" else (96, 0))
    assert eng.pool_stats()["pages_in_use"] == 0


def test_hybrid_layout_summary_matches_jax(served):
    """mamba on the 10 mamba layers and a ring on the 2 attention
    positions, as the JAX engine resolves them, under both layouts."""
    for layout in LAYOUTS:
        jeng, _, eng, _ = served(layout)
        assert eng.layout_summary() == jeng.layout_summary()
        kinds = [(d["kind"], d["layout"]) for d in eng.layout_summary()]
        assert kinds == ([("mamba", "mamba")] * 5 + [("attn", "ring")]) * 2


def test_hybrid_prefix_trie_snapshots_mamba_states(served):
    """Each of the paged engine's prefix entries (the two distinct prompts'
    32-token prefixes) holds a copy of every mamba layer's six leaves (the
    carry after 2 whole chunks, empty buffers) and of the rings, which the
    hit restored: the third request reused the first's prefix and got the
    JAX engine's tokens."""
    _, _, eng, _ = served("paged")
    entries = [e for _, e in eng._radix.items()]
    assert len(entries) == 2
    for entry in entries:
        assert entry.length == 32 and entry.pages == ()
        for i, (snap, kind) in enumerate(zip(entry.state, eng.cfg.layer_kinds())):
            assert sorted(snap) == (MAMBA_KEYS if kind == "mamba" else ["k", "pos", "v"]), i
        assert entry.state[0]["ssm"].any() and not entry.state[0]["ssd_x"].any()
    assert sum(e.hits for e in entries) == 1


def test_hybrid_engine_batch_invariance_and_scrub(served):
    """A request re-served alone gives the tokens it got beside another
    (joint against solo); retiring it in the run's last tick scrubs its
    slot's six mamba leaves and its ring rows."""
    _, _, eng, got = served("dense")
    for uid in (0, 1):
        r = _trace(eng.cfg.vocab, Request)[uid]
        eng.submit(Request(uid=10 + uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens))
        np.testing.assert_array_equal(eng.run()[10 + uid].tokens, got[uid].tokens)
        for cache in eng.caches:
            for key, buf in cache.items():
                if key == "pos":
                    assert (buf[0] == -1).all()
                else:
                    assert not buf[0].any(), key
        assert sorted(eng.caches[0]) == MAMBA_KEYS


def _cfg_hybrid(base):
    """tests/test_paged_kv.py's CFG_HYBRID, built from either package."""
    return base.ModelConfig(
        name="tiny-paged-hybrid", family="hybrid", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=256,
        layer_pattern=("mamba", "attn"),
        ternary=base.TernaryConfig(das=base.DasConfig(16, 8)),
        ssm=base.SsmConfig(16, 16, 2, 4, chunk=8),
        dtype="float32", remat=False, scan_layers=False)


def test_cfg_hybrid_paged_engine_matches_jax():
    """A mamba layer beside a full-attention layer paged through the arena
    (LPSA off: each prompt prefills whole; no prefix sharing, as
    tests/test_paged_kv.py runs it), prompts of 11, 17, 9 and the first
    again, 6 greedy tokens each, 2 steps apart: the JAX engine's tokens,
    vtimes and pool stats, every page back after the run, and every slot's
    carry zero (a retired slot is scrubbed, and a free row decodes at t =
    -1 into buffer row 0, which never folds)."""
    jcfg, tcfg = _cfg_hybrid(jbase), _cfg_hybrid(tbase)
    sparams = JMD.export_serving(JMD.init_params(jax.random.PRNGKey(2), jcfg), jcfg)
    model = load_serving_tree(jax.tree.map(np.asarray, sparams), tcfg, "cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (11, 17, 9)]
    prompts.append(prompts[0].copy())

    def trace(cls):
        return [cls(uid=i, prompt=p, max_new_tokens=6, arrival=2 * i)
                for i, p in enumerate(prompts)]

    kw = dict(max_slots=2, max_len=48, layout="paged", page_size=8, prefix_sharing=False)
    jeng, want, eng, got = _run(jcfg, sparams, model, kw, trace,
                                rt=Runtime(serve_sparse=False), serve_sparse=False)
    _same_results(want, got)
    assert eng.stats.prefill_tokens == jeng.stats.prefill_tokens == 48
    assert eng.layout_summary() == jeng.layout_summary()
    assert [d["layout"] for d in eng.layout_summary()] == ["mamba", "paged"]
    assert eng.pool_stats() == jeng.pool_stats()
    assert eng.pool_stats()["pages_in_use"] == 0 and eng.pool_stats()["pages_peak"] > 0
    assert not eng.caches[0]["ssm"].any()


def test_hybrid_decode_writes_states_in_place():
    """A decode step updates every mamba leaf in its own storage (the CUDA
    graph holds it); the step that fills a chunk folds the buffers into the
    carry and clears them."""
    cfg = tbase.reduced(get_config("zamba2-2.7b"))
    model = MD.init_serving(cfg, seed=1, device="cpu")
    tok = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, 14))[None]
    _, caches = MD.prefill(model, tok, max_len=16, serve_sparse=False)
    ptrs = [{k: v.data_ptr() for k, v in c.items()} for c in caches]
    for t in (14, 15):
        before = {k: v.clone() for k, v in caches[0].items()}
        MD.decode_step(model, caches, torch.tensor([5]), torch.tensor([t]), serve_sparse=False)
        changed = {k for k, v in caches[0].items() if not torch.equal(v, before[k])}
        assert changed == set(MAMBA_KEYS) - ({"ssm"} if t == 14 else set()), t
    assert not caches[0]["ssd_x"].any() and caches[0]["ssm"].any()
    assert [{k: v.data_ptr() for k, v in c.items()} for c in caches] == ptrs


def test_cli_serves_hybrid_reduced_on_cpu(capsys):
    res = cli.main(["--arch", "zamba2-2.7b", "--reduced", "--device", "cpu", "--requests",
                    "2", "--prompt-len", "20", "--gen", "3", "--slots", "2", "--stagger", "1"])
    assert sorted(res) == [0, 1] and all(len(r.tokens) == 3 for r in res.values())
    assert "zamba2-2.7b-smoke" in capsys.readouterr().out
