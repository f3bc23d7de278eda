"""SPMD serving of the port against the JAX package's single-device engine.

Reduced bitnet-1.3b, float32, on the JAX package's weights.  One world of 4
gloo ranks on the CPU (``distributed.launch.run_ranks``, spawned once for
the module) serves, in turn:

  * at Topology(dp=2, tp=2), the JAX test's trace (tests/
    test_sharded_serving.py: 4 requests, prompts of 24, 8 tokens, arrivals
    2 apart): greedy tokens equal to ``repro``'s engine run with
    ``Runtime(kernel_mode="sharded")`` (the JAX package's own topology run
    fails in this JAX: ROADMAP "State of the reference"), and one request
    teacher-forced, its logits within 2e-4 of ``repro``'s at every step;
  * the same with ``FaultInjector(fail_at=(3,))`` and 2 ranks lost: the
    same tokens, ``reshards == 1``, Topology(dp=1, tp=2) after it, the two
    lost ranks retired;
  * the paged layout (full attention, pages of 8) at Topology(1, 2) on
    ranks 0 and 1: ``repro``'s paged tokens;
  * the model with one kv head (``n_kv_heads=1``, its own weights) at
    Topology(1, 2) on ranks 0 and 1, the kv head replicated on both
    (``models.model.kv_replicas``): ``repro``'s tokens, and one request
    teacher-forced within 2e-4 of ``repro``'s logits.

The CLI: ``--tp 2 --dp 2 --device cpu`` prints the one-device run's
``[serve] req`` lines, and ``--tp 3`` is an argparse error.  The row-
parallel sums add the partials in another order than one device does, so
the logits agree within the tolerance, not bitwise (ROADMAP "Differences
that are not faults").
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import base as tbase
from repro_torch.configs import get_config
from repro_torch.distributed.launch import run_ranks
from repro_torch.distributed.plan import Topology
from repro_torch.launch import serve as cli
from repro_torch.serve import Request, ServeConfig

ROOT = Path(__file__).resolve().parents[1]
ARCH, MAX_LEN, TOL = "bitnet-1.3b", 32, 2e-4


def _trace(cfg, request=Request, n=4, prompt_len=24, gen=8, stagger=2):
    """The JAX test's trace (test_sharded_serving.py:29-36)."""
    rng = np.random.default_rng(7)
    return [request(uid=i, prompt=np.asarray(rng.integers(0, cfg.vocab, (prompt_len,)),
                                             np.int32),
                    max_new_tokens=gen, arrival=i * stagger) for i in range(n)]


def _tokens(results):
    return {uid: np.asarray(r.tokens).tolist() for uid, r in results.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """repro's single-device runs, and the port's world of 4 ranks over the
    same weights: (want, got), got[rank] = the three jobs' outputs."""
    import jax
    import jax.numpy as jnp

    from repro.configs import base as jbase
    from repro.configs import get_config as jget
    from repro.models import model as JMD
    from repro.models.transformer import Runtime
    from repro.serve import Request as JRequest
    from repro.serve import ServeConfig as JServeConfig
    from repro.serve import ServeEngine as JServeEngine
    from repro_torch.bridge import load_serving_tree
    torch.set_num_threads(1)
    jcfg, tcfg = jbase.reduced(jget(ARCH)), tbase.reduced(get_config(ARCH))
    jcfg1, tcfg1 = (dataclasses.replace(c, n_kv_heads=1) for c in (jcfg, tcfg))
    tmp = tmp_path_factory.mktemp("dist_serve")

    def model(jc, tc, seed, name):
        """repro's serving params of ``jc`` and the port's weights file."""
        sp = JMD.export_serving(JMD.init_params(jax.random.PRNGKey(seed), jc), jc)
        path = str(tmp / name)
        torch.save(load_serving_tree(jax.tree.map(np.asarray, sp), tc, "cpu").state_dict(),
                   path)
        return sp, path

    def jrun(jc, sp, serve_sparse=True, **kw):
        eng = JServeEngine(jc, sp, Runtime(kernel_mode="sharded", serve_sparse=serve_sparse),
                           config=JServeConfig(max_slots=4, max_len=MAX_LEN, **kw))
        for r in _trace(jc, JRequest):
            eng.submit(r)
        return _tokens(eng.run())

    def teacher(jc, sp, tokens):
        """Request 0 teacher-forced: its pack-aligned prefix, then the rest
        of its prompt and its first 7 tokens, a decode step each ->
        ((prefix, forced), repro's logits after each)."""
        prompt = _trace(jc)[0].prompt
        forced = [int(t) for t in prompt[16:]] + tokens[0][:7]
        rt = Runtime(kernel_mode="sharded")
        lg, caches = jax.jit(lambda p, x: JMD.prefill(p, jc, x, rt, max_len=MAX_LEN))(
            sp, jnp.asarray(prompt[:16])[None])
        step = jax.jit(lambda p, c, tok, t: JMD.decode_step(p, jc, c, tok, t, rt))
        logits = [np.asarray(lg[0])]
        for i, tok in enumerate(forced):
            lg, caches = step(sp, caches, jnp.asarray([tok], jnp.int32),
                              jnp.asarray([16 + i], jnp.int32))
            logits.append(np.asarray(lg[0]))
        return (prompt[:16], forced), logits

    sparams, path = model(jcfg, tcfg, 0, "weights.pt")
    sparams1, path1 = model(jcfg1, tcfg1, 1, "weights_kv1.pt")
    want = {"auto": jrun(jcfg, sparams),
            "paged": jrun(jcfg, sparams, False, layout="paged", page_size=8),
            "kv1": jrun(jcfg1, sparams1)}
    feed, want["teacher"] = teacher(jcfg, sparams, want["auto"])
    feed1, want["kv1_teacher"] = teacher(jcfg1, sparams1, want["kv1"])

    trace = tuple(_trace(tcfg))
    dp2tp2 = ServeConfig(max_slots=4, max_len=MAX_LEN, topology=Topology(dp=2, tp=2))
    tp2 = ServeConfig(max_slots=4, max_len=MAX_LEN, topology=Topology(dp=1, tp=2))
    jobs = [cli.RankJob(tcfg, dp2tp2, weights=path, trace=trace, teachers=(feed,)),
            cli.RankJob(tcfg, dp2tp2, weights=path, trace=trace, fail_at=(3,), lost=2),
            cli.RankJob(tcfg, dataclasses.replace(tp2, layout="paged", page_size=8),
                        weights=path, trace=trace, serve_sparse=False),
            cli.RankJob(tcfg1, tp2, weights=path1, trace=tuple(_trace(tcfg1)),
                        teachers=(feed1,))]
    got = run_ranks(cli.serve_jobs, 4, jobs)
    return want, got


def test_dp2_tp2_tokens_match_jax(runs):
    want, got = runs
    for rank in range(4):
        out = got[rank][0]
        assert out["tokens"] == want["auto"], f"rank {rank}"
        assert out["topology"] == Topology(dp=2, tp=2)
        assert out["stats"]["reshards"] == 0


def test_dp2_tp2_teacher_forced_logits_match_jax(runs):
    want, got = runs
    for rank in range(4):
        steps = got[rank][0]["teachers"][0]
        assert len(steps) == len(want["teacher"]) == 16
        for i, (g, w) in enumerate(zip(steps, want["teacher"])):
            np.testing.assert_allclose(g, w, rtol=0, atol=TOL,
                                       err_msg=f"rank {rank}, step {i}")
            assert int(np.argmax(g)) == int(np.argmax(w))
    # every rank of the world gathers the same logits
    for rank in range(1, 4):
        for a, b in zip(got[0][0]["teachers"][0], got[rank][0]["teachers"][0]):
            np.testing.assert_array_equal(a, b)


def test_recovery_after_losing_two_ranks(runs):
    want, got = runs
    for rank in (0, 1):
        out = got[rank][1]
        assert out["tokens"] == want["auto"], f"rank {rank}"
        assert out["stats"]["reshards"] == 1
        assert out["stats"]["recovery_seconds"] > 0
        assert out["topology"] == Topology(dp=1, tp=2)
    assert got[2][1] is None and got[3][1] is None   # the lost ranks left


def test_paged_tp2_tokens_match_jax(runs):
    want, got = runs
    for rank in (0, 1):
        assert got[rank][2]["tokens"] == want["paged"], f"rank {rank}"
    assert got[2][2] is None and got[3][2] is None   # outside Topology(1, 2)


def test_replicated_kv_head_tp2_matches_jax(runs):
    """One kv head under tp 2: each rank holds it whole (its q heads read
    it), and the sharded engine gives ``repro``'s tokens and logits."""
    from repro_torch.models import model as MD
    want, got = runs
    cfg1 = dataclasses.replace(tbase.reduced(get_config(ARCH)), n_kv_heads=1)
    assert MD.kv_replicas(cfg1, 2) == 2
    for rank in (0, 1):
        out = got[rank][3]
        assert out["tokens"] == want["kv1"], f"rank {rank}"
        assert out["topology"] == Topology(dp=1, tp=2)
        steps = out["teachers"][0]
        assert len(steps) == len(want["kv1_teacher"]) == 16
        for i, (g, w) in enumerate(zip(steps, want["kv1_teacher"])):
            np.testing.assert_allclose(g, w, rtol=0, atol=TOL, err_msg=f"rank {rank}, step {i}")
    assert got[2][3] is None and got[3][3] is None   # outside Topology(1, 2)


def test_cli_dp2_tp2_prints_the_one_device_lines(capsys):
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--requests", "4",
            "--prompt-len", "24", "--gen", "8", "--stagger", "2"]
    cli.main(argv)
    one = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[serve] req")]
    assert len(one) == 4
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}

    def spmd(*extra):
        res = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *argv,
                              "--tp", "2", "--dp", "2", *extra],
                             capture_output=True, text=True, env=env, timeout=300)
        assert res.returncode == 0, res.stderr[-3000:]
        return res.stdout.splitlines()

    lines = spmd()
    assert "[serve] spawning 4 ranks over gloo" in lines
    assert "[serve] topology: dp=2 tp=2 (4 devices, mesh axes ('data', 'model'))" in lines
    assert [ln for ln in lines if ln.startswith("[serve] req")] == one
    # a loss of 2 ranks at step 3: the same tokens (a replayed request's
    # first token and finish come later), on the shrunk topology
    lines = spmd("--inject-failure", "3", "--inject-lost", "2")
    ids = [ln.split(", ids ")[1] for ln in lines if ln.startswith("[serve] req")]
    assert ids == [ln.split(", ids ")[1] for ln in one]
    assert any(ln.startswith("[serve] recovery clean: all 4 in-flight requests completed "
                             "(reshards=1,") and ln.endswith("topology dp=1 tp=2)")
               for ln in lines), lines


@pytest.mark.parametrize("argv,msg", [
    (["--tp", "3"], "tp=3 does not divide bitnet-1.3b's n_heads=32, n_kv_heads=32"),
    (["--tp", "-1", "--device", "cpu"], "--tp/--dp must be >= 1"),
    (["--tp", "2", "--device", "cpu", "--dist-backend", "nccl"], "nccl needs CUDA"),
    (["--tp", "2", "--reduced", "--device", "cpu", "--serve-http"], "--serve-http"),
    (["--tp", "2", "--arch", "rwkv6-3b", "--reduced", "--device", "cpu"],
     "ROADMAP queue 1, item 2")])
def test_cli_topology_errors(capsys, argv, msg):
    with pytest.raises(SystemExit):
        cli.main(argv)
    assert msg in capsys.readouterr().err


@pytest.mark.parametrize("layout,fail_at", [("auto", (3,)), ("paged", (3,)), ("auto", (2, 9))])
def test_inplace_recovery_replays_every_request(tmp_path, layout, fail_at):
    """One device (no topology): an injected WorkerFailure rebuilds the
    device state in place and replays every in-flight request; the tokens
    are the failure-free run's, one reshard a failure, and the telemetry
    logs it (the JAX test_sharded_serving.py's in-process checks)."""
    import json

    from repro_torch.distributed.fault import FaultInjector
    from repro_torch.models import model as MD
    from repro_torch.serve import ServeEngine, Telemetry
    torch.set_num_threads(1)
    cfg = tbase.reduced(get_config(ARCH))
    model = MD.init_serving(cfg, seed=0, device="cpu")
    sc = ServeConfig(max_slots=4, max_len=40, layout=layout,
                     page_size=8 if layout == "paged" else 16)

    def run(injector=None, path=None):
        eng = ServeEngine(model, sc, device="cpu", serve_sparse=layout != "paged")
        if injector is not None:
            eng.fault_injector = injector
        if path is not None:
            Telemetry(engine=eng, jsonl_path=path)
        for r in _trace(cfg, gen=12):
            eng.submit(r)
        return eng, _tokens(eng.run())

    _, want = run()
    path = str(tmp_path / "telemetry.jsonl")
    eng, got = run(FaultInjector(fail_at=fail_at), path)
    assert got == want
    assert eng.stats.reshards == len(fail_at) and eng.stats.recovery_seconds > 0
    eng.telemetry.close()
    resh = [ln for ln in map(json.loads, open(path)) if ln["type"] == "reshard"]
    assert len(resh) == len(fail_at) and resh[0]["in_flight_replayed"] >= 1
    assert resh[0]["topology"] is None
