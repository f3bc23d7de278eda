"""The port's block-paged KV pool against the JAX package's.

The paged cache write and gathered read, the page pool and radix trie, and
the paged engine, each fed the same seeded numpy inputs in both packages.
Exact throughout: the cache layer and the host bookkeeping are integer or
copy operations, and the engine's greedy tokens and accounting must be
equal.  The engine case runs reduced bitnet-1.3b with LPSA (ring layers, so
no page arena: exact prefix states shared through the trie) and with
full-cache layers (every layer a page arena: whole-page donors, exact hits
with a partial boundary page, copy-on-write).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import kvcache as JKV
from repro.models.transformer import Runtime
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve import kvpool as jpool
from repro_torch.configs import get_config, reduced
from repro_torch.models import kvcache as KV
from repro_torch.serve import Request, ServeConfig, ServeEngine
from repro_torch.serve import kvpool as tpool
from test_torch_model import jax_and_port

PAGE, MAX_LEN = 8, 64


def test_paged_write_read_matches_jax():
    """One token per row into a shared arena through a page table, rows 1
    and 3 inactive (t = -1: the null page, position -1), then the gathered
    view.  Exact, except the null page's K/V: inactive rows all write it,
    and which of them lands is unspecified in both packages (its positions
    stay -1, so nothing reads it)."""
    rng = np.random.default_rng(0)
    cfg = reduced(get_config("bitnet-1.3b"))
    n_pages, b, n_seq = 10, 4, 3
    spec = KV.CacheSpec("paged", b, max_len=n_seq * PAGE, page_size=PAGE,
                        num_pages=n_pages, dtype=torch.float32)
    arena = {k: v.numpy() for k, v in KV.init_cache(cfg, spec).items()}
    shp = arena["k_pages"].shape
    arena["k_pages"] = rng.standard_normal(shp).astype(np.float32)
    arena["v_pages"] = rng.standard_normal(shp).astype(np.float32)
    arena["pos_pages"][1:] = rng.integers(0, 24, (n_pages - 1, PAGE)).astype(np.int32)
    pt = np.array([[1, 2, 0], [3, 0, 0], [4, 5, 6], [0, 0, 0]], np.int32)
    t = np.array([13, -1, 17, -1], np.int32)
    kv_new = [rng.standard_normal((b, 1, cfg.n_kv_heads, cfg.head_dim_)).astype(np.float32)
              for _ in range(2)]

    port = {k: torch.from_numpy(v.copy()) for k, v in arena.items()}
    KV.attn_write(port, *(torch.from_numpy(x) for x in kv_new), torch.from_numpy(t),
                  None, torch.arange(b), torch.from_numpy(pt))
    got = KV.attn_read(port, torch.from_numpy(pt))
    ref = JKV.attn_write({k: jnp.asarray(v) for k, v in arena.items()},
                         *(jnp.asarray(x) for x in kv_new), jnp.asarray(t), sink=0,
                         window=0, ring=False, page_table=jnp.asarray(pt))
    want = JKV.attn_read(ref, jnp.asarray(pt))
    np.testing.assert_array_equal(port["pos_pages"].numpy(), np.asarray(ref["pos_pages"]))
    assert (port["pos_pages"][0] == -1).all()
    for key in ("k_pages", "v_pages"):
        np.testing.assert_array_equal(port[key][1:].numpy(), np.asarray(ref[key])[1:])
    k_pos = np.asarray(want[2])
    np.testing.assert_array_equal(got[2].numpy(), k_pos)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy()[k_pos >= 0], np.asarray(w)[k_pos >= 0])


def _run_pool_script(mod, seed: int) -> list:
    """Apply one seeded script of pool and trie operations to ``mod``'s
    PagePool and RadixIndex; -> everything they returned or reported."""
    rng = np.random.default_rng(seed)
    pool, idx = mod.PagePool(12, 4), mod.RadixIndex()
    held, keys, log = [], [], []
    stems = [tuple(rng.integers(0, 5, 6)) for _ in range(2)]

    def entry_key(e):
        return None if e is None else (e.length, e.pages)

    for _ in range(120):
        op = rng.integers(0, 6)
        if op == 0:
            p = pool.alloc()
            if p is not None:
                held.append(p)
            log.append(("alloc", p))
        elif op == 1 and held:
            pages = [held[i] for i in rng.integers(0, len(held), 2)]
            pool.retain(pages)
            held.extend(pages)
            log.append(("retain", pages))
        elif op == 2 and held:
            pages = [held.pop(int(rng.integers(0, len(held))))]
            log.append(("release", pages, pool.release(pages)))
        elif op == 3:
            toks = stems[rng.integers(0, 2)][:rng.integers(1, 7)] + tuple(
                rng.integers(0, 5, rng.integers(0, 4)))
            e = mod.PrefixEntry(length=len(toks), pages=tuple(held[:2]))
            ok = idx.insert(toks, e)
            if ok:
                keys.append(toks)
            log.append(("insert", toks, ok))
        elif op == 4:
            q = stems[rng.integers(0, 2)][:rng.integers(0, 7)] + tuple(
                rng.integers(0, 5, rng.integers(0, 5)))
            best, donor, common = idx.lookup(q)
            log.append(("lookup", q, entry_key(best), entry_key(donor), common))
        elif op == 5 and keys:
            toks = keys.pop(int(rng.integers(0, len(keys))))
            log.append(("remove", toks, entry_key(idx.remove(toks))))
        log.append((pool.refs.tolist(), pool.free_count, pool.pages_in_use,
                    pool.peak_in_use, len(idx),
                    sorted((k, entry_key(e)) for k, e in idx.items())))
    return log


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pool_and_radix_match_jax(seed):
    """The same script of alloc, retain, release, insert, lookup and remove
    on both packages' PagePool and RadixIndex: every result and every state
    after each step equal."""
    assert _run_pool_script(tpool, seed) == _run_pool_script(jpool, seed)


def _stem_trace(vocab, request_cls, gen=6):
    """Five prompts around one 35-token stem (2 packs of 16 + 3): fresh, a
    sibling tail, a duplicate of the first, an extension of the first and
    the stem's first 32 tokens; 2 steps apart."""
    rng = np.random.default_rng(5)
    stem = rng.integers(0, vocab, 35)
    tail = lambda n: rng.integers(0, vocab, n)  # noqa: E731
    first = np.concatenate([stem, tail(9)])
    prompts = [first, np.concatenate([stem, tail(5)]), first.copy(),
               np.concatenate([first, tail(6)]), stem[:32]]
    return [request_cls(uid=i, prompt=p.astype(np.int32), max_new_tokens=gen,
                        arrival=2 * i) for i, p in enumerate(prompts)]


PAGED_CASES = {"lpsa": True, "full-cache": False}   # serve_sparse


@pytest.fixture(scope="module", params=sorted(PAGED_CASES))
def paged_runs(request):
    """(name, port paged engine, its results, port dense results, JAX paged
    engine, its results) on the stem trace, max_slots 2."""
    sparse = PAGED_CASES[request.param]
    jcfg, sparams, tcfg, model, mode = jax_and_port("bitnet-reduced")
    paged = dict(max_slots=2, max_len=MAX_LEN, layout="paged", page_size=PAGE)
    jeng = JServeEngine(jcfg, sparams, Runtime(serve_sparse=sparse),
                        config=JServeConfig(kernel_mode=mode, **paged))
    eng = ServeEngine(model, ServeConfig(**paged), device="cpu", serve_sparse=sparse)
    dense = ServeEngine(model, ServeConfig(max_slots=2, max_len=MAX_LEN), device="cpu",
                        serve_sparse=sparse)
    for e, cls in ((jeng, JRequest), (eng, Request), (dense, Request)):
        for r in _stem_trace(jcfg.vocab, cls):
            e.submit(r)
    jres = jeng.run()
    return request.param, eng, eng.run(), dense.run(), jeng, jres


def test_paged_engine_matches_jax(paged_runs):
    name, eng, got, _, jeng, want = paged_runs
    assert sorted(got) == sorted(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid].tokens, want[uid].tokens,
                                      err_msg=f"{name} request {uid}")
        assert got[uid].first_token_vtime == want[uid].first_token_vtime
        assert got[uid].finish_vtime == want[uid].finish_vtime
    for field in ("prefill_tokens", "prefix_hits", "prompt_tokens_reused", "cow_copies",
                  "prefix_evictions", "pool_peak_pages", "decode_steps"):
        assert getattr(eng.stats, field) == getattr(jeng.stats, field), field
    assert eng.pool_stats() == jeng.pool_stats()
    # the trace reuses the stem on every admission after the first
    assert eng.stats.prefix_hits == 4
    if name == "full-cache":
        assert eng.stats.cow_copies >= 1 and eng.pool_stats()["pages_peak"] > 0
    else:
        assert eng.pool_stats()["layout"] == "dense"   # no arena: ring states only


def test_paged_engine_matches_dense_engine(paged_runs):
    """Sharing prefixes changes what is prefilled, not the tokens."""
    name, eng, got, dense, _, _ = paged_runs
    assert sorted(got) == sorted(dense)
    for uid in dense:
        np.testing.assert_array_equal(got[uid].tokens, dense[uid].tokens,
                                      err_msg=f"{name} request {uid}")


def test_paged_pool_exhaustion_defers_not_crashes():
    """A pool of 3 usable pages of 8 for 2 slots: admissions wait for pages
    instead of failing, every request completes with the dense engine's
    tokens, and a request that can never fit is refused at submission."""
    _, _, _, model, _ = jax_and_port("bitnet-reduced")
    cfg = ServeConfig(max_slots=2, max_len=48, layout="paged", page_size=PAGE,
                      num_pages=4)
    eng = ServeEngine(model, cfg, device="cpu", serve_sparse=False)
    dense = ServeEngine(model, ServeConfig(max_slots=2, max_len=48), device="cpu",
                        serve_sparse=False)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, model.cfg.vocab, 10).astype(np.int32) for _ in range(3)]
    for e in (eng, dense):
        for i, p in enumerate(prompts):
            e.submit(Request(uid=i, prompt=p, max_new_tokens=8))
    got, want = eng.run(), dense.run()
    assert sorted(got) == [0, 1, 2]
    for uid in want:
        np.testing.assert_array_equal(got[uid].tokens, want[uid].tokens)
    assert eng.stats.pool_peak_pages <= 3
    with pytest.raises(ValueError, match="pages"):
        eng.submit(Request(uid=9, prompt=rng.integers(0, 64, 30), max_new_tokens=10))


def test_serve_config_paged_validation_matches_jax():
    """The paged fields validate as the JAX package's do, with its messages."""
    for kw in (dict(layout="ring"), dict(layout="paged", page_size=0),
               dict(layout="paged", max_len=50, page_size=16),
               dict(layout="paged", num_pages=1)):
        with pytest.raises(ValueError) as port_err:
            ServeConfig(**kw)
        with pytest.raises(ValueError) as jax_err:
            JServeConfig(**kw)
        assert str(port_err.value) == str(jax_err.value)
    for kw in (dict(), dict(layout="paged", max_len=64, page_size=16),
               dict(layout="paged", max_slots=3, max_len=96, page_size=32, num_pages=7)):
        port, ref = ServeConfig(**kw), JServeConfig(**kw)
        assert (port.pages_per_seq, port.resolved_num_pages()) == \
            (ref.pages_per_seq, ref.resolved_num_pages())
