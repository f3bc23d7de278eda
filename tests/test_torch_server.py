"""The port's front door against the JAX package's: telemetry, HTTP, soak.

``Telemetry`` must count what ``EngineStats`` counts.  The HTTP server is
driven in-process on an ephemeral port by raw asyncio clients (HTTP/1.1 with
``Connection: close``, so one read to EOF takes a unary or an SSE body):
unary and streamed completions, greedy and sampled, must carry the tokens
and step counts that the JAX package's ``ServeHTTPServer`` answers to the
same payloads; concurrent streams must carry the tokens of a fresh
``run()`` of the same requests under the same uids (keys depend on uid and
token index only); a full queue answers 429; results are claimed as they
finish.  The CLI's ``--serve-http`` serves a stdlib client and shuts down
cleanly on SIGINT.
"""
import asyncio
import json
import os
import signal
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from repro.models.transformer import Runtime
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve.server import ServeHTTPServer as JServeHTTPServer
from repro_torch.serve import Request, ServeConfig, ServeEngine, Telemetry
from repro_torch.serve.server import ServeHTTPServer
from test_serve_engine import CFG as JCFG
from test_torch_hybrid import one_thread  # noqa: F401
from test_torch_sampler import tiny  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def _engine(tiny, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_len", 64)
    return ServeEngine(tiny[1], ServeConfig(**kw), device="cpu")


def _req(uid, plen=4, gen=3, arrival=0, slo=None, temp=0.0):
    rng = np.random.default_rng(uid)
    return Request(uid=uid, prompt=rng.integers(0, JCFG.vocab, plen).astype(np.int32),
                   max_new_tokens=gen, arrival=arrival, slo_steps=slo, temperature=temp)


def test_telemetry_matches_engine_stats(tiny, tmp_path):
    path = tmp_path / "metrics.jsonl"
    eng = _engine(tiny, scheduler="deadline")
    tele = Telemetry(engine=eng, jsonl_path=str(path), snapshot_every=4)
    for i in range(5):
        eng.submit(_req(i, slo=200 if i % 2 else None, temp=0.7 * (i % 3 == 0)))
    res = eng.run()
    assert len(res) == 5
    assert tele.tokens_out == eng.stats.generated_tokens == 15
    assert tele.requests_finished == 5
    assert tele.preemptions == eng.stats.preemptions == 0
    assert tele.slo_tracked == 2 and tele.slo_met == 2
    assert tele.queue_wait_steps == sum(r.queue_wait_steps for r in res.values())
    assert tele.ticks_seen == eng.stats.decode_steps
    snap = tele.snapshot(eng)
    assert snap["totals"]["tokens_out"] == eng.stats.generated_tokens
    assert snap["slo_attainment"] == 1.0
    assert snap["engine"]["decode_steps"] == eng.stats.decode_steps
    assert snap["engine"]["generated_tokens"] == eng.stats.generated_tokens
    assert snap["engine"]["preemptions"] == eng.stats.preemptions
    assert "kernel_fallbacks" not in snap["engine"]
    assert snap["pool"]["layout"] == "dense"
    assert 0.0 < snap["rolling"]["slot_utilization"] <= 1.0
    tele.close()
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    reqs = [x for x in lines if x["type"] == "request"]
    assert len(reqs) == 5 and [x for x in lines if x["type"] == "tick"]
    assert sum(x["new_tokens"] for x in reqs) == eng.stats.generated_tokens


def test_pop_result_soak_bounded_results_and_uid_cycling(tiny):
    """1500 requests through run_forever, each result claimed in on_finish:
    the results stay bounded while 16 uids cycle, and telemetry keeps pace
    with the engine's counters."""
    n, n_uids = 1500, 16
    eng = _engine(tiny, max_slots=8)
    tele = Telemetry(engine=eng)
    rng = np.random.default_rng(0)
    state = {"submitted": 0, "inflight": set(), "finished": 0, "max_results": 0}

    def on_finish(result):
        assert eng.pop_result(result.uid).uid == result.uid
        state["inflight"].discard(result.uid)
        state["finished"] += 1

    def poll():
        while state["submitted"] < n:
            uid = state["submitted"] % n_uids
            if uid in state["inflight"]:
                return
            eng.submit(Request(uid=uid, prompt=rng.integers(0, JCFG.vocab, int(
                rng.integers(3, 6))).astype(np.int32), max_new_tokens=2, arrival=eng.vtime,
                temperature=0.5 * (uid % 2)))
            state["inflight"].add(uid)
            state["submitted"] += 1
            state["max_results"] = max(state["max_results"], len(eng._results))

    eng.on_finish = on_finish
    eng.run_forever(poll=poll)
    assert state["submitted"] == state["finished"] == n
    assert eng._results == {} and state["max_results"] <= n_uids
    assert tele.requests_finished == n
    assert tele.tokens_out == eng.stats.generated_tokens == 2 * n


async def _http(port, method, path, body=None):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = json.dumps(body).encode() if body is not None else b""
    writer.write(f"{method} {path} HTTP/1.1\r\nHost: t\r\nContent-Type: application/json\r\n"
                 f"Content-Length: {len(payload)}\r\n\r\n".encode() + payload)
    await writer.drain()
    raw = await asyncio.wait_for(reader.read(), timeout=60)
    writer.close()
    head, _, body_raw = raw.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    headers = {k.strip().lower(): v.strip()
               for k, v in (ln.split(":", 1) for ln in lines[1:] if ":" in ln)}
    return int(lines[0].split(" ")[1]), headers, body_raw


def _events(body: bytes) -> list:
    return [ln[len("data: "):] for ln in body.decode().split("\n\n") if ln.startswith("data: ")]


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, timeout=120))


PAYLOADS = [{"prompt": [1, 2, 3, 4], "max_tokens": 4},
            {"prompt": "hello", "max_tokens": 3, "temperature": 0.8},
            {"prompt": [5, 6, 7, 8, 9, 10, 11, 12, 13], "max_tokens": 5, "stream": True,
             "temperature": 0.9, "slo_steps": 200},
            {"prompt": list(range(16)), "max_tokens": 4, "stream": True},
            {"prompt": [7] * 11, "max_tokens": 6, "temperature": 5.0, "stream": True}]


async def _answers(srv):
    """The five payloads one after another, then /metrics -> (per payload
    (token ids, usage), the snapshot after the engine thread has joined: a
    tick's counter moves after its tokens are posted, so /metrics read at
    once may miss the last tick)."""
    await srv.start()
    out = []
    for body in PAYLOADS:
        st, hdr, raw = await _http(srv.port, "POST", "/v1/completions", body)
        assert st == 200, raw
        if body.get("stream"):
            assert hdr["content-type"] == "text/event-stream"
            ev = _events(raw)
            assert ev[-1] == "[DONE]"
            chunks = [json.loads(e) for e in ev[:-1]]
            toks = [c["choices"][0]["token_ids"] for c in chunks[:-1]]
            assert all(len(t) == 1 for t in toks) and len(toks) == body["max_tokens"]
            out.append(([t[0] for t in toks], chunks[-1]["usage"]))
        else:
            res = json.loads(raw)
            out.append((res["choices"][0]["token_ids"], res["usage"]))
    st, _, raw = await _http(srv.port, "GET", "/metrics")
    assert st == 200 and json.loads(raw)["totals"]["requests_finished"] == len(PAYLOADS)
    await srv.stop()
    assert not srv._thread.is_alive(), "engine thread not joined"
    return out, srv.telemetry.snapshot(srv.engine)


def test_http_answers_match_jax_server(tiny):
    sparams, _ = tiny
    kw = dict(max_slots=4, max_len=64, scheduler="deadline", top_k=8, seed=3)
    jeng = JServeEngine(JCFG, sparams, Runtime(), config=JServeConfig(**kw))
    want, jsnap = _run(_answers(JServeHTTPServer(jeng, port=0, default_slo_steps=100)))
    eng = _engine(tiny, **kw)
    got, snap = _run(_answers(ServeHTTPServer(eng, port=0, default_slo_steps=100)))
    assert got == want
    assert snap["totals"] == {k: jsnap["totals"][k] for k in snap["totals"]}
    assert snap["totals"]["tokens_out"] == eng.stats.generated_tokens == 22
    assert snap["engine"]["decode_steps"] == eng.stats.decode_steps == jeng.stats.decode_steps
    assert eng._results == {} and eng.stats.sampling_steps > 0


def test_http_errors_and_backpressure(tiny):
    srv = ServeHTTPServer(_engine(tiny), port=0, max_queue_depth=0)   # always full

    async def scenario():
        await srv.start()
        st, hdr, body = await _http(srv.port, "POST", "/v1/completions",
                                    {"prompt": [1, 2], "max_tokens": 1})
        assert st == 429 and hdr.get("retry-after") == "1"
        assert "capacity" in json.loads(body)["error"]["message"]
        srv.max_queue_depth = 8
        for bad in ({"prompt": []}, {"prompt": ""}, {"prompt": 42}, {"prompt": [999999]},
                    {"prompt": [1], "max_tokens": -1}, {"prompt": [1], "max_tokens": "lots"}):
            st, _, body = await _http(srv.port, "POST", "/v1/completions", bad)
            assert st == 400 and "message" in json.loads(body)["error"], bad
        assert (await _http(srv.port, "GET", "/nope"))[0] == 404
        st, _, body = await _http(srv.port, "GET", "/healthz")
        assert st == 200 and json.loads(body)["ok"] is True
        await srv.stop()

    _run(scenario())


def test_http_concurrent_streams_match_fresh_run(tiny):
    """Six streams at once over four slots, three of them sampled: each
    stream's tokens equal a fresh engine's run() of the same requests with
    the uids the server gave them."""
    eng = _engine(tiny, scheduler="deadline")
    srv = ServeHTTPServer(eng, port=0, max_queue_depth=16)
    bodies = [{"prompt": [i + 1, i + 2, i + 3], "max_tokens": 4, "stream": True,
               "temperature": 0.8 * (i % 2)} for i in range(6)]

    async def one(body):
        st, _, raw = await _http(srv.port, "POST", "/v1/completions", body)
        assert st == 200
        chunks = [json.loads(e) for e in _events(raw)[:-1]]
        return int(chunks[0]["id"].split("-")[1]), [c["choices"][0]["token_ids"][0]
                                                    for c in chunks[:-1]]

    async def scenario():
        await srv.start()
        got = await asyncio.gather(*(one(b) for b in bodies))
        st, _, raw = await _http(srv.port, "GET", "/metrics")
        assert json.loads(raw)["totals"]["requests_finished"] == 6
        await srv.stop()
        return got

    got = _run(scenario())
    assert eng._results == {}
    fresh = _engine(tiny)
    for (uid, _), body in zip(got, bodies):
        fresh.submit(Request(uid=uid, prompt=np.asarray(body["prompt"], np.int32),
                             max_new_tokens=4, temperature=body["temperature"]))
    res = fresh.run()
    assert {uid: toks for uid, toks in got} == {u: r.tokens.tolist() for u, r in res.items()}


def test_cli_serve_http_clean_shutdown():
    """``--serve-http`` on a reduced model: a stdlib client's completion and
    /metrics, then SIGINT -> exit 0 with the clean-shutdown line."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                                        os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "bitnet-1.3b",
         "--reduced", "--device", "cpu", "--serve-http", "--port", "0", "--slots", "2",
         "--prompt-len", "16", "--gen", "8", "--slo-steps", "64", "--top-k", "40"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        for line in proc.stdout:
            if "http front door on" in line:
                url = line.split("http front door on ")[1].split(" ")[0]
                break
        else:
            pytest.fail("the server never came up")
        req = urllib.request.Request(f"{url}/v1/completions", method="POST",
                                     data=json.dumps({"prompt": [3, 1, 4, 1, 5],
                                                      "max_tokens": 4,
                                                      "temperature": 0.8}).encode())
        with urllib.request.urlopen(req, timeout=60) as resp:
            out = json.loads(resp.read())
        assert len(out["choices"][0]["token_ids"]) == 4 and out["usage"]["slo_met"]
        with urllib.request.urlopen(f"{url}/metrics", timeout=60) as resp:
            assert json.loads(resp.read())["totals"]["requests_finished"] == 1
        proc.send_signal(signal.SIGINT)
        rest = proc.communicate(timeout=60)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, rest
    assert "[serve] clean shutdown: " in rest and "1 requests served" in rest
