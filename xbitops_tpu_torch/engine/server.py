"""A minimal OpenAI-style HTTP endpoint over the :class:`Engine` (port of
``xbitops_tpu/engine/server.py``), stdlib only:

- ``POST /v1/completions``: body ``{"prompt": [ids] | "text", "max_tokens":
  N, "temperature": t}``; blocks until the generation finishes and returns
  ``{"id", "choices": [{"tokens", "text"?, "finish_reason"}], "usage":
  {...}}``.  A string prompt needs a tokenizer (pass one to
  :class:`ServingEndpoint`).
- ``GET /health``: liveness and the engine's configuration.

Requests are micro-batched: one worker thread drains the queue and runs one
:meth:`Engine.generate` per wave, so concurrent clients share admission
forwards and decode bursts.  Arrivals during a running wave wait for the
next.  The worker is the only thread that touches the device (on a CUDA
engine it captures and replays the decode graphs); the HTTP threads wait on
an event.

Spans (``utils/tracing.py``): ``endpoint.request`` a request, from its
enqueueing to its waiter's wake-up, under the id the engine serves it by;
``endpoint.wave`` a wave, from its first take to waking its waiters (the
parent of its ``engine.generate``), and ``endpoint.gather`` its batching
window.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from xbitops_tpu_torch.engine.engine import Engine, Request
from xbitops_tpu_torch.utils import tracing

__all__ = ["ServingEndpoint"]


class _Pending:
    __slots__ = ("request", "event", "completion", "error", "queued_ns")

    def __init__(self, request: Request):
        self.request = request
        self.event = threading.Event()
        self.completion = None
        self.error: Optional[str] = None
        self.queued_ns = 0


class ServingEndpoint:
    """HTTP front end over one :class:`Engine` (one device context).

    ``endpoint.serve_forever()`` blocks; ``start()`` runs it on a daemon
    thread and returns the bound port (``port=0`` picks a free one)."""

    def __init__(self, engine: Engine, host: str = "127.0.0.1",
                 port: int = 8000, tokenizer=None,
                 batch_window_s: float = 0.01):
        self.engine = engine
        self.tokenizer = tokenizer
        self.batch_window_s = batch_window_s
        self._queue: "queue.Queue[_Pending]" = queue.Queue()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._drain, daemon=True)
        self._httpd = ThreadingHTTPServer((host, port), self._handler_class())
        self.port = self._httpd.server_address[1]
        self._served = 0

    # --- worker: micro-batching over Engine.generate ---

    def _drain(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            with tracing.span("endpoint.wave") as wave_span:
                wave = [first]
                with tracing.span("endpoint.gather", mirror=True):
                    t0 = time.monotonic()
                    # collect arrivals within the batching window (up to slot count)
                    while (len(wave) < self.engine.slots
                           and time.monotonic() - t0 < self.batch_window_s):
                        try:
                            wave.append(self._queue.get_nowait())
                        except queue.Empty:
                            time.sleep(0.001)
                wave_span.attrs["requests"] = len(wave)
                try:
                    outs = self.engine.generate([p.request for p in wave])
                    by_id = {c.id: c for c in outs}
                    for p in wave:
                        p.completion = by_id.get(p.request.id)
                        if p.completion is None:
                            p.error = "generation dropped the request"
                except Exception as e:  # engine fault: every waiter learns it
                    for p in wave:
                        p.error = f"{type(e).__name__}: {e}"
                for p in wave:
                    p.event.set()
            self._served += len(wave)

    # --- request handling ---

    def _submit(self, body: dict) -> _Pending:
        prompt = body.get("prompt")
        if isinstance(prompt, str):
            if self.tokenizer is None:
                raise ValueError(
                    "string prompt needs a tokenizer; send token ids")
            prompt = self.tokenizer(prompt)["input_ids"]
        if not isinstance(prompt, list) or not all(
                isinstance(t, int) for t in prompt):
            raise ValueError("prompt must be a string or a list of token ids")
        eos = None
        if self.tokenizer is not None:
            eos = getattr(self.tokenizer, "eos_token_id", None)
        p = _Pending(Request(
            prompt=prompt,
            max_new_tokens=int(body.get("max_tokens", 64)),
            temperature=float(body.get("temperature", 0.0)),
            eos_id=body.get("eos_id", eos),
            id=None,  # engine assigns a unique id
        ))
        # engine ids are assigned in generate(); mint one here so the wave
        # can match completions to waiters
        p.request.id = self._next_id()
        p.queued_ns = time.monotonic_ns()
        self._queue.put(p)
        return p

    _id_lock = threading.Lock()
    _id_counter = 0

    @classmethod
    def _next_id(cls) -> int:
        with cls._id_lock:
            cls._id_counter += 1
            return cls._id_counter

    def _handler_class(self):
        endpoint = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet by default
                pass

            def _json(self, code: int, obj: dict) -> None:
                data = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/health":
                    eng = endpoint.engine
                    self._json(200, dict(
                        status="ok", slots=eng.slots,
                        kv_quant=eng.kv_quant,
                        max_seq_len=eng.cfg.max_seq_len,
                        served=endpoint._served,
                    ))
                else:
                    self._json(404, dict(error="not found"))

            def do_POST(self):
                if self.path != "/v1/completions":
                    self._json(404, dict(error="not found"))
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n) or b"{}")
                    p = endpoint._submit(body)
                except (ValueError, json.JSONDecodeError) as e:
                    self._json(400, dict(error=str(e)))
                    return
                p.event.wait()
                tracing.record("endpoint.request", p.queued_ns, time.monotonic_ns(),
                               request=p.request.id)
                if p.error is not None:
                    self._json(500, dict(error=p.error))
                    return
                c = p.completion
                choice = dict(tokens=c.tokens, finish_reason=c.finish_reason)
                if endpoint.tokenizer is not None:
                    choice["text"] = endpoint.tokenizer.decode(c.tokens)
                self._json(200, dict(
                    id=f"cmpl-{c.id}",
                    choices=[choice],
                    usage=dict(
                        prompt_tokens=c.prompt_len,
                        completion_tokens=len(c.tokens),
                        total_tokens=c.prompt_len + len(c.tokens),
                    ),
                ))

        return Handler

    # --- lifecycle ---

    def start(self) -> int:
        """Serve on a daemon thread; returns the bound port."""
        self._worker.start()
        threading.Thread(
            target=self._httpd.serve_forever, daemon=True).start()
        return self.port

    def serve_forever(self) -> None:
        self._worker.start()
        self._httpd.serve_forever()

    def shutdown(self) -> None:
        """Stop serving, close the socket, and wait for the wave in flight."""
        self._stop.set()
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._worker.is_alive():
            self._worker.join()
