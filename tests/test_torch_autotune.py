"""The port's tuned mode against the JAX package's: the native decode-GEMMs
(kernels/native_gemm.py) against its ``xla_gemm``, the autotune cache and
its key, the launch configs' feasibility, ``KernelMode``, the tuned
dispatch of ``tlin_apply`` and a tuned engine's greedy tokens.

Every test points the cache at ``tmp_path`` through
``TENET_TORCH_AUTOTUNE_CACHE``: none writes under ``~``.  The native GEMMs
are held on explicit seeded cases (m = 5 and K % 5 != 0 among them), not on
hypothesis draws.
"""
import json
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import das as jdas
from repro.core import twd as jtwd
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import xla_gemm
from repro.models.transformer import Runtime
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_config, reduced
from repro_torch.core import twd
from repro_torch.kernels import autotune, build, native_gemm, ops
from repro_torch.launch import serve as cli
from repro_torch.models import ternary_linear as TL
from repro_torch.serve import Request, ServeConfig, ServeEngine
from test_torch_model import jax_and_port

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def cache_env(tmp_path, monkeypatch):
    path = tmp_path / "autotune.json"
    monkeypatch.setenv(autotune.ENV_VAR, str(path))
    return path


def _t(a):
    return torch.from_numpy(np.array(a))


def _packed(rng, k, n):
    trits = rng.integers(-1, 2, size=(k, n)).astype(np.int8)
    return np.array(jtwd.pack_ternary(jnp.asarray(trits)))     # the JAX export's bytes


# (m, k, n): m = 5 (the reference's Pallas GEMM refuses it) at K % 5 == 0
# (every impl), and K % 5 != 0 (f32dec refuses it, plain takes it)
GEMM_CASES = [(5, 320, 96), (1, 337, 64)]


@pytest.mark.parametrize("m,k,n", GEMM_CASES)
def test_native_gemms_match_xla_gemm(rng, m, k, n):
    x = rng.standard_normal((m, k)).astype(np.float32)
    packed = _packed(rng, k, n)
    scale = np.float32(0.37)
    xs = (rng.random((m, 1)) + 0.5).astype(np.float32)
    for impl in ("native_plain", "native_dense_plain") + (
            ("native_f32dec", "native_dense_f32dec") if k % 5 == 0 else ()):
        ximpl = "xla_" + impl[len("native_"):]
        for x_scale in (None, xs) if impl == "native_plain" else (None,):
            got = native_gemm.decode_matmul(_t(x), _t(packed), torch.tensor(scale), impl=impl,
                                            x_scale=None if x_scale is None else _t(x_scale))
            want = xla_gemm.decode_matmul(jnp.asarray(x), jnp.asarray(packed), scale,
                                          impl=ximpl, x_scale=None if x_scale is None
                                          else jnp.asarray(x_scale))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    if k % 5:
        with pytest.raises(ValueError, match="K % 5 == 0"):
            native_gemm.f32dec_matmul(_t(x), _t(packed), 0.5)
    with pytest.raises(ValueError, match="unknown impl"):
        native_gemm.decode_matmul(_t(x), _t(packed), 0.5, impl="native_nope")


@pytest.mark.parametrize("m,k", [(5, 320), (3, 100)])
def test_densify_helpers_match_exactly(rng, m, k):
    """masked_dense (a dense tail where the block does not divide K) and
    scatter_dense of the JAX compaction, bit for bit; gather_matmul against
    the JAX gather oracle within 1e-4."""
    x = rng.standard_normal((m, k)).astype(np.float32)
    np.testing.assert_array_equal(
        native_gemm.masked_dense(_t(x), keep=16, block=32).numpy(),
        np.asarray(xla_gemm.masked_dense(jnp.asarray(x), keep=16, block=32)))
    if k % 32:
        return
    ca = jdas.das_compact(jnp.asarray(x), block_size=32, keep=16)
    vals, idx = np.asarray(ca.values), np.asarray(ca.indices)
    np.testing.assert_array_equal(
        native_gemm.scatter_dense(_t(vals), _t(idx), k, keep=16, block=32).numpy(),
        np.asarray(xla_gemm.scatter_dense(ca.values, ca.indices, k, keep=16, block=32)))
    packed = _packed(rng, k, 48)
    got = native_gemm.gather_matmul(_t(vals), _t(idx), _t(packed), torch.tensor(0.5))
    want = jref.das_ternary_gemm_ref(ca.values, ca.indices, jnp.asarray(packed),
                                     jnp.float32(0.5), k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="K / block \\* keep"):
        native_gemm.scatter_dense(_t(vals), _t(idx), k + 32, keep=16, block=32)


def test_cache_round_trip_and_corrupt_files(cache_env):
    cache = autotune.AutotuneCache()
    assert cache.path == str(cache_env) and cache.entries == {}
    cfg = autotune.TileConfig("cuda", subs=2)
    cache.put("k1", cfg, 12.345, {"cuda subs=2": 12.345, "native_plain": 30.0})
    again = autotune.AutotuneCache()
    assert again.get("k1") == cfg and again.get("nope") is None
    assert again.entries["k1"]["us"] == 12.35 and again.entries["k1"]["timed"]["native_plain"] == 30
    payload = json.loads(cache_env.read_text())
    assert payload["version"] == 1 and payload["package"] == "repro_torch"
    for bad in ("{not json", json.dumps([1, 2]), json.dumps({"version": 2, "entries": {}}),
                # the JAX package's cache file: no package mark, never read
                json.dumps({"version": 1, "entries": {"k1": {"impl": "pallas"}}})):
        cache_env.write_text(bad)
        assert autotune.AutotuneCache().entries == {}
    fresh = autotune.AutotuneCache()
    fresh.put("k2", autotune.TileConfig("native_plain"), 1.0)
    assert autotune.AutotuneCache().get("k2") == autotune.TileConfig("native_plain")


def test_default_path_is_per_device(monkeypatch):
    monkeypatch.delenv(autotune.ENV_VAR)
    path = autotune.default_cache_path("cpu")
    assert path.endswith(os.path.join(".cache", "tenet-repro-torch", "autotune-cpu.json"))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda d=None: (9, 0))
    assert autotune.device_name("cuda") == "NVIDIA_H100_80GB_HBM3-sm90"


def test_tune_hits_cost_no_timed_runs_and_lookup_is_pure(cache_env):
    dims = autotune.gemm_dims(m=4, k=320, n=64, keep=16, block=32, dtype=torch.float32)
    cache = autotune.AutotuneCache()
    cfg = autotune.tune("das_ternary_gemm", device="cpu", cache=cache, budget=None,
                        iters=2, **dims)
    assert cache.timed_runs == len(autotune.candidates("das_ternary_gemm", "cpu", **dims))
    key = autotune.shape_key("das_ternary_gemm", "cpu", **dims)
    assert set(cache.entries[key]["timed"]) == {
        c.name for c in autotune.candidates("das_ternary_gemm", "cpu", **dims)}
    second = autotune.AutotuneCache()
    assert autotune.tune("das_ternary_gemm", device="cpu", cache=second, **dims) == cfg
    assert second.timed_runs == 0
    # lookup: a cache read, else what "auto" runs (the plain version on the
    # CPU); never times or writes
    mtime, text = os.stat(cache_env).st_mtime_ns, cache_env.read_text()
    assert autotune.lookup("das_ternary_gemm", device="cpu", cache=second, **dims) == cfg
    miss = autotune.gemm_dims(m=256, k=640, n=64, keep=16, block=32, dtype=torch.float32)
    assert autotune.lookup("das_ternary_gemm", device="cpu", cache=second, **miss) == \
        autotune.TileConfig("plain")
    assert second.timed_runs == 0 and len(second.entries) == 1
    assert os.stat(cache_env).st_mtime_ns == mtime and cache_env.read_text() == text


def test_lookup_miss_takes_the_kernel_on_the_card(monkeypatch):
    """On the card a shape no warmup tuned takes the hand-written kernel at
    its built-in config, whatever the perfmodel's estimates (they price the
    native impls at the int8 peak); a hit takes the cached config.  The
    card's name is stubbed."""
    monkeypatch.setattr(autotune, "device_name", lambda d: "FAKE_H100-sm90")
    cache = autotune.AutotuneCache()
    decode_attn = autotune.attn_dims(hq=32, hkv=32, lq=1, lk=1024, d=64, sink=1 << 30,
                                     window=0, dtype=torch.bfloat16)
    shapes = autotune._small_shapes(torch.bfloat16) + [("sparse_attn", decode_attn)]
    for op, dims in shapes:
        assert autotune.lookup(op, device="cuda", cache=cache, **dims) == \
            autotune.TileConfig("cuda"), op
    won = autotune.TileConfig("native_flash", kv_chunk=256)
    cache.put(autotune.shape_key("sparse_attn", "FAKE_H100-sm90", **decode_attn), won, 1.0)
    assert autotune.lookup("sparse_attn", device="cuda", cache=cache, **decode_attn) == won
    assert cache.timed_runs == 0


def test_das_step_writes_dense_rows_only_for_a_native_dense_winner(rng, tmp_path):
    """Under "tuned" the DAS step writes the masked dense rows beside its
    compaction only where a cached das_ternary_gemm winner at its rows' key
    (K, dtype, keep, block, class; any N) is a native dense impl: a miss
    takes the kernel, and the kernel reads the compaction alone."""
    tc = _lin(rng, 320, 64, True).tc
    x = torch.from_numpy(rng.standard_normal((3, 320)).astype(np.float32))

    def dense_written(winners):
        cache = autotune.AutotuneCache(str(tmp_path / f"c{len(os.listdir(tmp_path))}.json"))
        for (m, k, n), impl in winners:
            dims = autotune.gemm_dims(m=m, k=k, n=n, keep=16, block=32, dtype=torch.float32)
            cache.put(autotune.shape_key("das_ternary_gemm", "cpu", **dims),
                      autotune.TileConfig(impl), 1.0)
        with ops.kernel_mode("tuned", cache):
            return TL.tlin_compact(x, tc).dense is not None

    assert not dense_written([])
    assert not dense_written([((4, 320, 64), "plain"), ((4, 320, 96), "native_gather")])
    assert dense_written([((4, 320, 64), "plain"), ((1, 320, 96), "native_dense_plain")])
    assert dense_written([((2, 320, 64), "native_dense_f32dec")])
    assert not dense_written([((256, 320, 64), "native_dense_plain"),     # another class
                              ((4, 640, 64), "native_dense_plain")])      # another K


def test_shape_key_is_order_free_and_has_no_m_within_a_class():
    a = autotune.shape_key("op", "cpu", k=1, n=2, cls="decode")
    assert a == autotune.shape_key("op", "cpu", cls="decode", n=2, k=1)
    kw = dict(k=2048, n=5460, keep=16, block=32, dtype=torch.bfloat16)
    assert autotune.gemm_dims(m=1, **kw) == autotune.gemm_dims(m=4, **kw)
    assert autotune.gemm_dims(m=5, **kw) == autotune.gemm_dims(m=256, **kw)
    assert autotune.gemm_dims(m=4, **kw) != autotune.gemm_dims(m=5, **kw)
    assert "m" not in autotune.gemm_dims(m=4, **kw)
    att = autotune.attn_dims(hq=4, hkv=2, lq=8, lk=64, d=16, sink=1 << 30, window=0,
                             dtype=torch.float32)
    assert att["sink"] == 64 and att["window"] == 0 and att["rs"] == 0


def test_candidates_are_the_feasible_configs():
    """On the card: the kernel at each feasible subs (a column tile of
    ceil(windows / subs) blocks within one cluster of 16) or parts (1..8, at
    most the windows; the tensor-core route only), and the native impls; on
    the CPU the plain version and the native impls."""
    bf, f32 = torch.bfloat16, torch.float32
    das = dict(keep=16, block=32)
    names = lambda op, dev, **d: [c.name for c in autotune.candidates(op, dev, **d)]  # noqa: E731
    # q/k/v/o: 13 windows
    assert names("das_ternary_gemm", "cuda", **autotune.gemm_dims(
        m=4, k=2048, n=2048, dtype=bf, **das)) == [
        "cuda subs=1", "cuda subs=2", "cuda subs=4", "cuda subs=8", "native_dense_plain",
        "native_gather"]
    assert names("das_ternary_gemm", "cuda", **autotune.gemm_dims(
        m=256, k=2048, n=5460, dtype=bf, **das))[:8] == [f"cuda parts={p}" for p in range(1, 9)]
    # the down projection: 35 windows, so subs 1 and 2 overflow a cluster
    assert names("ternary_gemm", "cuda", **autotune.gemm_dims(m=4, k=5460, n=2048, dtype=bf)) \
        == ["cuda subs=4", "cuda subs=8", "native_f32dec", "native_plain"]
    # float32 rows take the FMA prefill: no knob
    assert names("ternary_gemm", "cuda", **autotune.gemm_dims(
        m=256, k=5460, n=2048, dtype=f32)) == ["cuda", "native_f32dec", "native_plain"]
    # 3 windows: parts up to 3
    assert names("ternary_gemm", "cuda", **autotune.gemm_dims(
        m=64, k=480, n=64, dtype=bf))[:4] == ["cuda parts=1", "cuda parts=2", "cuda parts=3",
                                              "native_f32dec"]
    assert names("das_ternary_gemm", "cpu", **autotune.gemm_dims(
        m=4, k=320, n=64, dtype=f32, **das)) == [
        "plain", "native_dense_f32dec", "native_dense_plain", "native_gather"]
    att = dict(hq=4, hkv=2, d=16, sink=8, window=24)
    assert names("sparse_attn", "cuda", **autotune.attn_dims(
        lq=1, lk=1024, dtype=bf, **att)) == [
        "cuda", "native_flash kv_chunk=128", "native_flash kv_chunk=256",
        "native_flash kv_chunk=512", "native_flash kv_chunk=1024"]
    # a rounded-scores pack in bf16: flash_masked would compute another function
    assert names("sparse_attn", "cuda", **autotune.attn_dims(
        lq=256, lk=1280, dtype=bf, round_scores=True, **att)) == ["cuda"]
    assert names("sparse_attn", "cpu", **autotune.attn_dims(
        lq=256, lk=1280, dtype=f32, round_scores=True, **att)) == [
        "plain", "native_flash kv_chunk=128", "native_flash kv_chunk=256",
        "native_flash kv_chunk=1280"]
    with pytest.raises(ValueError, match="whole blocks"):
        autotune.candidates("das_ternary_gemm", "cpu", **autotune.gemm_dims(
            m=4, k=100, n=8, dtype=f32, **das))


@pytest.mark.parametrize("m,k,n,dtype,config,ok", [
    (4, 5460, 64, torch.bfloat16, build.LaunchConfig(subs=1), False),     # 35 windows
    (4, 5460, 64, torch.bfloat16, build.LaunchConfig(subs=4), True),
    (4, 2048, 64, torch.bfloat16, build.LaunchConfig(subs=3), False),
    (8, 2048, 64, torch.bfloat16, build.LaunchConfig(parts=8), True),
    (8, 2048, 64, torch.bfloat16, build.LaunchConfig(parts=9), False),
    (64, 320, 64, torch.bfloat16, build.LaunchConfig(parts=3), False),     # 2 windows
    (4, 2048, 64, torch.bfloat16, build.LaunchConfig(parts=2), False),     # a prefill knob
    (8, 2048, 64, torch.bfloat16, build.LaunchConfig(subs=2), False),      # a decode knob
    (8, 2048, 64, torch.float32, build.LaunchConfig(parts=2), False),      # the FMA route
    (8, 2048, 64, torch.float32, build.DEFAULT_CONFIG, True)])
def test_launch_config_feasibility_on_the_cpu(rng, m, k, n, dtype, config, ok):
    """The wrappers check a config on either device (the plain version
    computes the same function at every feasible one) and raise on one the
    kernel would refuse, never replacing it."""
    packed = torch.from_numpy(_packed(rng, k, n))
    packed = torch.cat([packed, torch.full((twd.packed_rows(k, 16) - packed.shape[0], n), 121,
                                           dtype=torch.uint8)])
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(dtype)
    if not ok:
        with pytest.raises(ValueError, match="launch config"):
            ops.ternary_gemm(x, packed, 0.5, config=config)
        return
    torch.testing.assert_close(ops.ternary_gemm(x, packed, 0.5, config=config),
                               ops.ternary_gemm(x, packed, 0.5), rtol=0, atol=0)
    if k % 32:
        return
    step = ops.das_topk(x, keep=16)
    torch.testing.assert_close(
        ops.das_ternary_gemm(step.values, step.indices, packed, 0.5, keep=16, config=config),
        ops.das_ternary_gemm(step.values, step.indices, packed, 0.5, keep=16), rtol=0, atol=0)


ALL_JAX_NAMES = [m.value for m in jops.KernelMode] + sorted(jops._KERNEL_MODE_ALIASES)


@pytest.mark.parametrize("name", ALL_JAX_NAMES)
def test_kernel_mode_parses_every_jax_name(name):
    got = ops.KernelMode.parse(name)
    assert got.value == jops.KernelMode.parse(name).value
    assert ops.KernelMode.parse(f"  {name.upper()} ") is got
    assert ServeConfig(kernel_mode=name).kernel_mode == got.value
    assert got.behaviour == {"tuned": "tuned", "ref": "ref"}.get(got.value, "auto")


def test_kernel_mode_rejects_and_scopes():
    with pytest.raises(ValueError, match="valid modes are"):
        ops.KernelMode.parse("fastest")
    with pytest.raises(ValueError, match="valid modes are"):
        ServeConfig(kernel_mode="fastest")
    assert ops.current_dispatch() == ops.Dispatch("auto", None)
    cache = autotune.AutotuneCache()
    with ops.kernel_mode("autotune", cache):
        assert ops.current_dispatch() == ops.Dispatch("tuned", cache)
        with ops.kernel_mode("gspmd", cache):
            assert ops.current_dispatch() == ops.Dispatch("auto", None)
    assert ops.current_dispatch().mode == "auto"
    with ops.kernel_mode("tuned"):
        assert isinstance(ops.current_dispatch().cache, autotune.AutotuneCache)


def test_ref_refuses_a_cuda_tensor():
    """No mode runs a plain version on the card: under "ref" the device
    check raises for a CUDA tensor (a stand-in: this host has no card) and
    passes a CPU one; "auto" launches there."""
    fake = types.SimpleNamespace(device=torch.device("cuda"))
    assert ops._on_cuda(fake) is True
    with ops.kernel_mode("reference"):
        with pytest.raises(ValueError, match="CPU tensors only"):
            ops._on_cuda(fake)
        assert ops._on_cuda(torch.zeros(1)) is False
    with pytest.raises(ValueError, match="does not run on"):
        autotune.run_gemm(torch.zeros((1, 5)), torch.zeros((1, 8), dtype=torch.uint8), 0.5,
                          cfg=autotune.TileConfig("cuda"))


def _lin(rng, d_in, d_out, das):
    tc = reduced(get_config("bitnet-1.3b")).ternary
    if not das:
        tc = type(tc)(**{**tc.__dict__, "das": None})
    lin = TL.TernaryLinear(d_in, d_out, tc, "cpu")
    trits = torch.from_numpy(rng.integers(-1, 2, size=(d_in, d_out)).astype(np.int8))
    lin.packed.copy_(twd.pack_ternary(trits, row_align=TL.ROW_ALIGN))
    lin.scale.fill_(0.37)
    return lin


@pytest.mark.parametrize("d_in,d_out,das,m", [(320, 64, True, 4), (320, 64, True, 7),
                                              (100, 48, True, 3), (320, 64, False, 5)])
def test_tuned_tlin_apply_matches_the_plain_path(rng, d_in, d_out, das, m):
    """tlin_apply under "tuned" with every candidate forced into the cache
    against "auto" (the plain versions on the CPU): the DAS compaction's
    route (32 | K), the dense tail's (K = 100) and DAS off."""
    lin = _lin(rng, d_in, d_out, das)
    x = torch.from_numpy(rng.standard_normal((2, m, d_in)).astype(np.float32))
    want = TL.tlin_apply(lin, x)
    op = "das_ternary_gemm" if das and d_in % 32 == 0 else "ternary_gemm"
    kw = dict(keep=16, block=32) if op == "das_ternary_gemm" else {}
    dims = autotune.gemm_dims(m=2 * m, k=d_in, n=d_out, dtype=torch.float32, **kw)
    key = autotune.shape_key(op, "cpu", **dims)
    cands = autotune.candidates(op, "cpu", **dims)
    assert len(cands) >= 3
    for cfg in cands:
        cache = autotune.AutotuneCache()
        cache.put(key, cfg, 1.0)
        with ops.kernel_mode("tuned", cache):
            got = TL.tlin_apply(lin, x)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5, msg=cfg.name)


def _short_trace(cfg, request_cls):
    """Two requests, each a pack-aligned prefix of one pack and a tail, the
    second queued behind the first: one prefill shape."""
    rng = np.random.default_rng(5)
    c = cfg.lpsa.chunk
    return [request_cls(uid=i, prompt=rng.integers(0, cfg.vocab, c + tail).astype(np.int32),
                        max_new_tokens=6, arrival=i) for i, tail in enumerate((4, 2))]


def test_tuned_engine_matches_jax_ref_engine(cache_env):
    """Reduced bitnet-1.3b in float32: a tuned engine (every candidate of
    its shapes timed on this host) gives the greedy tokens of the JAX
    package's kernel_mode="ref" engine on the same weights; a second tuned
    engine on the populated cache does zero timed runs and gives them too."""
    jcfg, sparams, tcfg, model, _ = jax_and_port("bitnet-reduced")
    jeng = JServeEngine(jcfg, sparams, Runtime(),
                        config=JServeConfig(max_slots=2, max_len=64, kernel_mode="ref"))
    for r in _short_trace(jcfg, JRequest):
        jeng.submit(r)
    want = jeng.run()
    runs = []
    for _ in range(2):
        eng = ServeEngine(model, ServeConfig(max_slots=2, max_len=64, kernel_mode="tuned"),
                          device="cpu")
        assert eng.kernel_mode == "tuned" and eng.autotune_cache.path == str(cache_env)
        for r in _short_trace(tcfg, Request):
            eng.submit(r)
        res = eng.run()
        runs.append(eng.stats.autotune_timed_runs)
        for uid in want:
            np.testing.assert_array_equal(res[uid].tokens, want[uid].tokens,
                                          err_msg=f"request {uid}")
    assert runs[0] > 0 and runs[1] == 0
    keys = json.loads(cache_env.read_text())["entries"]
    # reduced bitnet-1.3b: every K (64, 128) whole DAS blocks
    assert {k.split("|")[0] for k in keys} == {"das_ternary_gemm", "sparse_attn"}


def test_engine_modes_and_the_cli(capsys, cache_env):
    """A Topology forces the per-shard kernels ("sharded") with a warning;
    the CLI takes --kernel-mode and rejects an unknown one."""
    from repro_torch.distributed.plan import Topology
    from repro_torch.models import model as MD
    cfg = reduced(get_config("bitnet-1.3b"))
    sc = ServeConfig(kernel_mode="tuned", topology=Topology(dp=1, tp=1))
    assert sc.kernel_mode == "tuned"
    eng = ServeEngine(MD.TernaryLM(cfg, "cpu"), ServeConfig(kernel_mode="ref"), device="cpu")
    assert eng.kernel_mode == "ref" and eng.autotune_cache is None
    cli.main(["--arch", "bitnet-1.3b", "--reduced", "--device", "cpu", "--requests", "2",
              "--prompt-len", "20", "--gen", "3", "--slots", "2", "--kernel-mode", "autotune"])
    out = capsys.readouterr().out
    assert "[serve] kernel mode tuned:" in out and str(cache_env) in out
    with pytest.raises(SystemExit):
        cli.main(["--reduced", "--device", "cpu", "--kernel-mode", "fastest"])


def test_tuned_mode_under_a_topology_warns(monkeypatch):
    """Under a topology a non-auto mode warns and the engine runs the
    per-shard kernels: checked before any rank is spawned."""
    from repro_torch.distributed.plan import Topology
    from repro_torch.models import model as MD
    from repro_torch.serve import engine as E
    cfg = reduced(get_config("bitnet-1.3b"))
    built = []
    monkeypatch.setattr(E.ServeEngine, "_build_device_state", lambda self: built.append(self))
    with pytest.warns(UserWarning, match="'sharded'"):
        eng = ServeEngine(MD.TernaryLM(cfg, "cpu"),
                          ServeConfig(kernel_mode="tuned", topology=Topology(dp=1, tp=2)),
                          device="cpu")
    assert eng.kernel_mode == "sharded" and eng.autotune_cache is None and built


def test_autotune_cli(capsys, cache_env):
    autotune.main(["--device", "cpu", "--budget", "1", "--iters", "1"])
    out = capsys.readouterr().out
    assert out.count("->") == 4 and "4 entries, 4 timed runs" in out
    autotune.main(["--device", "cpu", "--budget", "1", "--iters", "1"])
    assert "4 entries, 0 timed runs" in capsys.readouterr().out
