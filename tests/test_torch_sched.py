"""The port's scheduling against the JAX package's: deadlines, preemption,
the wave policy, ``ServeConfig`` validation, and the CLI's scheduling flags.

The schedulers are pure Python copies: the same submissions must pop in the
same order.  The engine cases of tests/test_slo_sched.py (EDF admission
under a burst, the preemption rescue and its budget rule) and the wave
case of tests/test_serve_engine.py run on both engines over the same
weights, and their results must be equal field by field.
"""
import numpy as np
import pytest

from repro.models.transformer import Runtime
from repro.serve import DeadlineScheduler as JDeadline
from repro.serve import FifoScheduler as JFifo
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch.launch import serve as cli
from repro_torch.serve import DeadlineScheduler, FifoScheduler, Request, ServeConfig, ServeEngine
from test_serve_engine import CFG as JCFG
from test_serve_engine import _trace as temperature_trace
from test_torch_hybrid import one_thread  # noqa: F401
from test_torch_sampler import _port_request, _same_results, tiny  # noqa: F401


def _script(fifo_cls, deadline_cls, req_cls, case):
    """One scheduling case of tests/test_slo_sched.py on either package's
    classes -> the uids in the order they popped (None: nothing ready)."""
    def mk(uid, arr, pri=0, slo=None):
        return req_cls(uid=uid, prompt=np.zeros(1, np.int32), max_new_tokens=1,
                       arrival=arr, priority=pri, slo_steps=slo)
    out = []
    if case == "aging":
        s = fifo_cls(aging_steps=8)
        s.add(mk(999, 0, pri=1))
        for now in range(64):
            s.add(mk(now, now))
            out.append(s.pop_ready(now).uid)
    elif case == "strict":
        s = fifo_cls(aging_steps=0)
        s.add(mk(999, 0, pri=1))
        for now in range(50):
            s.add(mk(now, now))
            out.append(s.pop_ready(now).uid)
    elif case == "edf":
        s = deadline_cls(aging_steps=8, default_slo=100)
        for args in ((0, 0, 0, 50), (1, 0, 0, 10), (2, 0), (3, 5, 0, 2)):
            s.add(mk(*args))
        out = [s.pop_ready(5).uid for _ in range(4)]
    elif case == "edf-aging":
        s = deadline_cls(aging_steps=4, default_slo=16)
        s.add(mk(999, 0, pri=2))
        for now in range(40):
            s.add(mk(now, now, slo=20))
            out.append(s.pop_ready(now).uid)
    elif case == "peek":
        s = deadline_cls()
        s.add(mk(0, 0, slo=10))
        s.add(mk(1, 3, slo=1))
        out = [s.peek_ready(0).uid, s.peek_ready(0).uid, s.peek_ready(3).uid,
               s.pop_ready(3).uid, s.pop_ready(3).uid, s.peek_ready(3),
               s.next_arrival()]
    return out


@pytest.mark.parametrize("case", ["aging", "strict", "edf", "edf-aging", "peek"])
def test_schedulers_pop_as_jax(case):
    want = _script(JFifo, JDeadline, JRequest, case)
    assert _script(FifoScheduler, DeadlineScheduler, Request, case) == want
    if case == "edf":
        assert want == [3, 1, 0, 2]


def _both(tiny, trace, **kw):
    """The trace on the JAX engine and on the port's -> (jax engine, its
    results, port engine, its results)."""
    sparams, model = tiny
    jeng = JServeEngine(JCFG, sparams, Runtime(), config=JServeConfig(**kw))
    eng = ServeEngine(model, ServeConfig(**kw), device="cpu")
    for r in trace:
        jeng.submit(r)
        eng.submit(_port_request(r))
    return jeng, jeng.run(), eng, eng.run()


def _prompt(rng, n):
    return np.asarray(rng.integers(0, JCFG.vocab, n), np.int32)


@pytest.mark.parametrize("sched", ["fifo", "deadline"])
def test_deadline_admission_on_burst_matches_jax(tiny, sched):
    """A tight-SLO request behind a burst of loose-SLO work: the same
    admissions and tokens as JAX, and under EDF no later than under FIFO."""
    rng = np.random.default_rng(0)
    trace = [JRequest(uid=i, prompt=_prompt(rng, 12), max_new_tokens=10, arrival=0,
                      slo_steps=200) for i in range(4)]
    trace.append(JRequest(uid=9, prompt=_prompt(rng, 4), max_new_tokens=2, arrival=1,
                          slo_steps=12))
    _, want, _, got = _both(tiny, trace, max_slots=2, max_len=64, scheduler=sched)
    _same_results(got, want)
    if sched == "deadline":
        _, fifo, _, _ = _both(tiny, trace, max_slots=2, max_len=64)
        assert got[9].admit_vtime <= fifo[9].admit_vtime


@pytest.mark.parametrize("preempt", [False, True])
def test_preemption_rescue_matches_jax(tiny, preempt):
    """One slot, a blocker over its own SLO and a critical arrival: without
    preemption the critical request misses; with it the blocker is
    truncated (a prefix of its full run) and the critical one meets its
    deadline; every result equal to JAX's."""
    rng = np.random.default_rng(1)
    trace = [JRequest(uid=0, prompt=_prompt(rng, 4), max_new_tokens=40, arrival=0,
                      slo_steps=5, temperature=0.9),
             JRequest(uid=1, prompt=_prompt(rng, 4), max_new_tokens=2, arrival=8,
                      slo_steps=10)]
    jeng, want, eng, got = _both(tiny, trace, max_slots=1, max_len=64,
                                 scheduler="deadline", preemption=preempt)
    _same_results(got, want)
    assert eng.stats.preemptions == jeng.stats.preemptions == int(preempt)
    assert got[0].preempted == preempt and got[1].slo_met == preempt
    if preempt:
        assert 0 < len(got[0].tokens) < 40 and not got[0].slo_met
        _, _, _, full = _both(tiny, trace, max_slots=1, max_len=64, scheduler="deadline")
        np.testing.assert_array_equal(got[0].tokens, full[0].tokens[:len(got[0].tokens)])


def test_preemption_spares_requests_within_budget(tiny):
    rng = np.random.default_rng(2)
    trace = [JRequest(uid=0, prompt=_prompt(rng, 4), max_new_tokens=10, arrival=0,
                      slo_steps=300),
             JRequest(uid=1, prompt=_prompt(rng, 4), max_new_tokens=2, arrival=1,
                      slo_steps=3)]
    jeng, want, eng, got = _both(tiny, trace, max_slots=1, max_len=64,
                                 scheduler="deadline", preemption=True)
    _same_results(got, want)
    assert eng.stats.preemptions == 0 and not got[0].preempted
    assert not got[1].slo_met


def test_wave_policy_matches_jax(tiny):
    """The lock-step baseline on the temperature trace: JAX's results, the
    continuous engine's tokens, and at least its decode steps."""
    trace = temperature_trace()
    jwave, want, wave, got = _both(tiny, trace, max_slots=2, max_len=64, policy="wave")
    _same_results(got, want)
    _, _, cont, cres = _both(tiny, trace, max_slots=2, max_len=64)
    for r in trace:
        np.testing.assert_array_equal(got[r.uid].tokens, cres[r.uid].tokens)
    assert wave.stats.decode_steps == jwave.stats.decode_steps >= cont.stats.decode_steps
    assert all(got[u].admitted_with_active == 0 for u in got)


def test_timed_replay_matches_jax(tiny):
    """timed_replay serves the trace twice and returns the second run, its
    stats that run's alone; reset_clock refuses an engine with work left."""
    sparams, model = tiny
    trace = temperature_trace()
    jeng = JServeEngine(JCFG, sparams, Runtime(), config=JServeConfig(max_slots=2, max_len=64))
    eng = ServeEngine(model, ServeConfig(max_slots=2, max_len=64), device="cpu")
    want = jeng.timed_replay(trace)
    got = eng.timed_replay([_port_request(r) for r in trace])
    _same_results(got, want)
    assert eng.stats.decode_steps == jeng.stats.decode_steps
    assert eng.stats.generated_tokens == sum(r.max_new_tokens for r in trace)
    eng.submit(_port_request(trace[0]))
    with pytest.raises(RuntimeError, match="non-drained"):
        eng.reset_clock()


BAD_CONFIGS = [dict(policy="lifo"), dict(scheduler="lifo"), dict(top_k=-1),
               dict(aging_steps=-1), dict(slo_default_steps=0), dict(preemption=True),
               dict(max_slots=0), dict(layout="paged", max_len=20, page_size=16)]


@pytest.mark.parametrize("kw", BAD_CONFIGS, ids=lambda kw: ",".join(kw))
def test_serve_config_messages_match_jax(kw):
    with pytest.raises(ValueError) as want:
        JServeConfig(**kw)
    with pytest.raises(ValueError) as got:
        ServeConfig(**kw)
    assert str(got.value) == str(want.value)


def test_serve_config_with_updates():
    sc = ServeConfig().with_updates(scheduler="deadline", preemption=True, top_k=40)
    assert (sc.scheduler, sc.preemption, sc.top_k) == ("deadline", True, 40)
    with pytest.raises(TypeError, match="unknown ServeConfig field"):
        ServeConfig().with_updates(no_such_field=None)
    assert ServeConfig().with_updates(kernel_mode="autotune").kernel_mode == "tuned"
    assert ServeConfig().with_updates(topology=None).topology is None
    ServeConfig(scheduler="deadline", preemption=True)


def test_cli_scheduling_flags(capsys):
    """--preemption without --scheduler deadline is an argparse error; a
    deadline run prints each request's SLO verdict and the attainment."""
    with pytest.raises(SystemExit):
        cli.main(["--arch", "bitnet-1.3b", "--reduced", "--device", "cpu", "--preemption"])
    assert "--preemption requires --scheduler deadline" in capsys.readouterr().err
    res = cli.main(["--arch", "bitnet-1.3b", "--reduced", "--device", "cpu",
                    "--requests", "3", "--prompt-len", "20", "--gen", "4", "--slots", "2",
                    "--temperature", "0.8", "--top-k", "40", "--scheduler", "deadline",
                    "--slo-steps", "6", "--preemption"])
    out = capsys.readouterr().out
    assert sorted(res) == [0, 1, 2]
    assert out.count("slo MET") + out.count("slo MISS") == 3
    assert "[serve] SLO attainment:" in out


def test_cli_paged_full_caches(capsys):
    res = cli.main(["--arch", "bitnet-1.3b", "--reduced", "--device", "cpu",
                    "--requests", "3", "--prompt-len", "20", "--gen", "4", "--slots", "2",
                    "--layout", "paged", "--page-size", "8", "--no-sparse", "--policy", "wave"])
    out = capsys.readouterr().out
    assert sorted(res) == [0, 1, 2]
    assert "[serve] paged pool:" in out and "pages peak" in out
    with pytest.raises(SystemExit):
        cli.main(["--arch", "bitnet-1.3b", "--reduced", "--device", "cpu",
                  "--layout", "paged", "--page-size", "0"])
