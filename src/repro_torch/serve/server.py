"""Asyncio HTTP front door over ServeEngine: streaming completions with
SLO-aware admission, backpressure and live telemetry.

A copy of the JAX package's ``serve/server.py`` (stdlib asyncio and a
minimal HTTP/1.1 parser, no web framework) over the port's engine.  The
engine runs on a thread of its own inside ``ServeEngine.run_forever``, and
every torch call (admission prefill, graph replay, the device sync of a
tick) runs there: submissions travel to it through a thread-safe inbox that
the engine thread drains between ticks (the ``poll`` hook), and sampled
tokens travel back through ``loop.call_soon_threadsafe`` into per-request
asyncio queues.  The event loop only parses, validates (host-side checks
of the request), queues, writes, and reads the engine's vitals (single
attributes, without the engine's lock, which admission holds).

Endpoints:

  POST /v1/completions   OpenAI-style completions.  JSON body:
        {"prompt": [ids...] | "text", "max_tokens": N, "temperature": T,
         "stream": bool, "slo_steps": N, "priority": P, "eos_id": id}
      ``prompt`` is a list of int token ids (the models carry random
      weights: there is no tokenizer); a string prompt is byte-tokenized
      (UTF-8 bytes mod vocab).  ``stream: true`` answers with Server-Sent
      Events: one ``data: {...}`` chunk per sampled token, a final chunk
      with the finish reason and usage, then ``data: [DONE]``.  A full queue
      (depth >= ``max_queue_depth``) answers 429 with Retry-After; a
      malformed or unservable request 400.
  GET  /metrics           the live Telemetry snapshot (JSON).
  GET  /healthz           liveness and engine vitals.

Request ids (``cmpl-<n>``) are engine uids from a counter, kept in
[1, 2^31) since the sampling key folds a uid as int32; results are claimed
(``pop_result``) the moment they finish, so the engine's memory and the uid
space stay bounded over an unbounded request stream.
"""

from __future__ import annotations

import asyncio
import dataclasses
import itertools
import json
import queue as _queue
import threading

import numpy as np

from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.metrics import Telemetry
from repro_torch.serve.scheduler import Request

__all__ = ["ServeHTTPServer"]

_MAX_BODY = 1 << 20
_UID_SPACE = 2 ** 31 - 1      # uids 1 .. 2^31 - 1: int32, as the keys fold them


class _HTTPError(Exception):
    def __init__(self, status: int, msg: str, retry_after: int | None = None):
        super().__init__(msg)
        self.status, self.msg, self.retry_after = status, msg, retry_after


_STATUS = {200: "OK", 400: "Bad Request", 404: "Not Found",
           405: "Method Not Allowed", 429: "Too Many Requests",
           500: "Internal Server Error"}


class ServeHTTPServer:
    """One engine, one listener.  ``await start()`` binds the socket and
    spawns the engine thread; ``await stop()`` drains and joins it (clean
    shutdown is test-asserted)."""

    def __init__(self, engine: ServeEngine, host: str = "127.0.0.1",
                 port: int = 8000, *, max_queue_depth: int = 64,
                 default_slo_steps: int | None = None,
                 telemetry: Telemetry | None = None):
        self.engine = engine
        self.host, self.port = host, port
        self.max_queue_depth = max_queue_depth
        self.default_slo_steps = default_slo_steps
        self.telemetry = telemetry or Telemetry(engine=engine)
        if engine.telemetry is None:
            self.telemetry.attach(engine)
        self._uid = itertools.count(1)
        self._streams: dict[int, asyncio.Queue] = {}   # uid -> event queue
        self._inbox: _queue.SimpleQueue = _queue.SimpleQueue()
        self._wake = threading.Event()
        self._stopping = False
        self._loop: asyncio.AbstractEventLoop | None = None
        self._server: asyncio.base_events.Server | None = None
        self._thread: threading.Thread | None = None
        engine.on_token = self._on_token
        engine.on_finish = self._on_finish

    # -- lifecycle --------------------------------------------------------

    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]  # resolve :0
        self._thread = threading.Thread(
            target=self.engine.run_forever,
            kwargs=dict(should_stop=lambda: self._stopping,
                        poll=self._drain_inbox, idle_wait=self._idle_wait),
            name="serve-engine", daemon=True)
        self._thread.start()

    async def stop(self) -> None:
        """Graceful shutdown: stop admitting, let the engine thread exit
        its loop, close the listener."""
        self._stopping = True
        self._wake.set()
        if self._thread is not None:
            await asyncio.get_running_loop().run_in_executor(
                None, self._thread.join, 10.0)
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        self.telemetry.close()

    async def serve_until(self, stop_event: asyncio.Event) -> None:
        await stop_event.wait()
        await self.stop()

    # -- engine-thread side ------------------------------------------------

    def _drain_inbox(self) -> None:
        """run_forever `poll` hook: move queued submissions into the
        engine on the engine thread (arrival stamped at the CURRENT
        vtime, the live-serving meaning of 'arrival')."""
        while True:
            try:
                req = self._inbox.get_nowait()
            except _queue.Empty:
                return
            req = dataclasses.replace(req, arrival=self.engine.vtime)
            try:
                self.engine.submit(req)
            except ValueError as e:   # raced capacity change etc.
                self._post(req.uid, ("error", str(e)))

    def _idle_wait(self) -> bool:
        self._wake.wait(0.05)
        self._wake.clear()
        return not self._stopping

    def _next_uid(self) -> int:
        return (next(self._uid) - 1) % _UID_SPACE + 1

    def _on_token(self, uid: int, tok: int) -> None:
        self._post(uid, ("token", tok))

    def _on_finish(self, result) -> None:
        # claim the result immediately: uids recycle, _results stays bounded
        claimed = self.engine.pop_result(result.uid)
        self._post(result.uid, ("finish", claimed or result))

    def _post(self, uid: int, event) -> None:
        loop = self._loop
        if loop is None or loop.is_closed():
            return
        loop.call_soon_threadsafe(self._dispatch, uid, event)

    def _dispatch(self, uid: int, event) -> None:
        q = self._streams.get(uid)
        if q is not None:
            q.put_nowait(event)

    # -- http plumbing -----------------------------------------------------

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            try:
                method, path, headers = await self._read_head(reader)
                body = await self._read_body(reader, headers)
                await self._route(method, path, body, writer)
            except _HTTPError as e:
                await self._send_json(writer, e.status,
                                      {"error": {"message": e.msg,
                                                 "code": e.status}},
                                      retry_after=e.retry_after)
            except (asyncio.IncompleteReadError, ConnectionResetError):
                pass
            except Exception as e:   # don't kill the listener
                try:
                    await self._send_json(
                        writer, 500, {"error": {"message": f"{type(e).__name__}: {e}",
                                                "code": 500}})
                except (ConnectionResetError, RuntimeError):
                    pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass

    async def _read_head(self, reader):
        raw = await reader.readuntil(b"\r\n\r\n")
        head = raw.decode("latin-1").split("\r\n")
        try:
            method, path, _ = head[0].split(" ", 2)
        except ValueError:
            raise _HTTPError(400, "malformed request line")
        headers = {}
        for line in head[1:]:
            if ":" in line:
                k, v = line.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        return method.upper(), path, headers

    async def _read_body(self, reader, headers) -> bytes:
        n = int(headers.get("content-length", 0) or 0)
        if n > _MAX_BODY:
            raise _HTTPError(400, f"body too large ({n} bytes)")
        return await reader.readexactly(n) if n else b""

    async def _route(self, method, path, body, writer) -> None:
        path = path.split("?", 1)[0]
        if path == "/v1/completions":
            if method != "POST":
                raise _HTTPError(405, "POST only")
            await self._completions(body, writer)
        elif path == "/metrics":
            await self._send_json(writer, 200,
                                  self.telemetry.snapshot(self.engine))
        elif path == "/healthz":
            await self._send_json(writer, 200, {
                "ok": True, "vtime": self.engine.vtime,
                "active_slots": self.engine.num_active,
                "queue_depth": self.queue_depth()})
        else:
            raise _HTTPError(404, f"no route for {path}")

    # -- the completions endpoint ------------------------------------------

    def queue_depth(self) -> int:
        return len(self.engine.scheduler) + self._inbox.qsize()

    def _parse_prompt(self, prompt) -> np.ndarray:
        vocab = self.engine.cfg.vocab
        if isinstance(prompt, str):
            if not prompt:
                raise _HTTPError(400, "empty prompt")
            ids = np.frombuffer(prompt.encode("utf-8"),
                                np.uint8).astype(np.int32) % vocab
            return ids
        if isinstance(prompt, list) and prompt and \
                all(isinstance(t, int) for t in prompt):
            ids = np.asarray(prompt, np.int32)
            if (ids < 0).any() or (ids >= vocab).any():
                raise _HTTPError(400, f"token ids must be in [0, {vocab})")
            return ids
        raise _HTTPError(400, "prompt must be a non-empty string or a "
                              "list of int token ids")

    def _build_request(self, payload: dict) -> Request:
        if not isinstance(payload, dict):
            raise _HTTPError(400, "body must be a JSON object")
        prompt = self._parse_prompt(payload.get("prompt"))
        slo = payload.get("slo_steps", self.default_slo_steps)
        try:
            req = Request(
                uid=self._next_uid(),
                prompt=prompt,
                max_new_tokens=int(payload.get("max_tokens", 16)),
                temperature=float(payload.get("temperature", 0.0)),
                eos_id=(int(payload["eos_id"])
                        if payload.get("eos_id") is not None else None),
                priority=int(payload.get("priority", 0)),
                slo_steps=int(slo) if slo is not None else None)
        except (TypeError, ValueError) as e:
            raise _HTTPError(400, f"bad request field: {e}")
        try:
            self.engine.validate(req)
        except ValueError as e:
            raise _HTTPError(400, str(e))
        return req

    async def _completions(self, body: bytes, writer) -> None:
        try:
            payload = json.loads(body or b"{}")
        except ValueError:
            raise _HTTPError(400, "body is not valid JSON")
        if self._stopping:
            raise _HTTPError(429, "server shutting down", retry_after=1)
        if self.queue_depth() >= self.max_queue_depth:
            raise _HTTPError(
                429, f"queue depth {self.queue_depth()} at capacity "
                     f"({self.max_queue_depth}); retry later", retry_after=1)
        req = self._build_request(payload)
        stream = bool(payload.get("stream", False))
        q: asyncio.Queue = asyncio.Queue()
        self._streams[req.uid] = q
        try:
            self._inbox.put(req)
            self._wake.set()
            if stream:
                await self._stream_response(req, q, writer)
            else:
                await self._unary_response(req, q, writer)
        finally:
            self._streams.pop(req.uid, None)

    @staticmethod
    def _chunk(req, tokens, finish_reason=None, *, obj="text_completion"):
        return {
            "id": f"cmpl-{req.uid}",
            "object": obj,
            "model": "tenet-repro",
            "choices": [{
                "index": 0,
                "text": " ".join(str(t) for t in tokens),
                "token_ids": [int(t) for t in tokens],
                "finish_reason": finish_reason,
            }],
        }

    async def _next_event(self, q: asyncio.Queue):
        ev = await q.get()
        if ev[0] == "error":
            raise _HTTPError(400, ev[1])
        return ev

    async def _unary_response(self, req, q, writer) -> None:
        while True:
            kind, val = await self._next_event(q)
            if kind == "finish":
                result = val
                break
        out = self._chunk(req, result.tokens.tolist(),
                          "preempted" if result.preempted else "stop")
        out["usage"] = {"prompt_tokens": req.prompt_len,
                        "completion_tokens": int(len(result.tokens)),
                        "ttft_steps": result.ttft_steps,
                        "latency_steps": result.latency_steps,
                        "slo_met": result.slo_met}
        await self._send_json(writer, 200, out)

    async def _stream_response(self, req, q, writer) -> None:
        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: text/event-stream\r\n"
                     b"Cache-Control: no-cache\r\n"
                     b"Connection: close\r\n\r\n")
        await writer.drain()
        while True:
            kind, val = await self._next_event(q)
            if kind == "token":
                data = self._chunk(req, [val], None,
                                   obj="text_completion.chunk")
                writer.write(b"data: " + json.dumps(data).encode() + b"\n\n")
                await writer.drain()
            elif kind == "finish":
                result = val
                data = self._chunk(req, [],
                                   "preempted" if result.preempted
                                   else "stop", obj="text_completion.chunk")
                data["usage"] = {"completion_tokens": int(len(result.tokens)),
                                 "ttft_steps": result.ttft_steps,
                                 "latency_steps": result.latency_steps,
                                 "slo_met": result.slo_met}
                writer.write(b"data: " + json.dumps(data).encode() + b"\n\n")
                writer.write(b"data: [DONE]\n\n")
                await writer.drain()
                return

    async def _send_json(self, writer, status: int, obj: dict,
                         retry_after: int | None = None) -> None:
        body = json.dumps(obj).encode()
        head = (f"HTTP/1.1 {status} {_STATUS.get(status, '')}\r\n"
                f"Content-Type: application/json\r\n"
                f"Content-Length: {len(body)}\r\n"
                f"Connection: close\r\n")
        if retry_after is not None:
            head += f"Retry-After: {retry_after}\r\n"
        writer.write(head.encode() + b"\r\n" + body)
        await writer.drain()
