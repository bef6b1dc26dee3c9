"""Stdlib HTTP transport for the serving front (no third-party deps).

A ``ThreadingHTTPServer`` exposing one ``ServingFront``:

- ``POST /v1/tenants/<name>/execute``: ``{"query": ..., "budget": ...?}``
  -> one answer-ladder JSON object (``kind``: answer | failed | rejected).
- ``POST /v1/tenants/<name>/explain``: same body -> plan-report JSON.
- ``POST /v1/tenants/<name>/stream``: same body -> chunked NDJSON, one
  refined answer per sample batch (``session.stream`` over the wire; the
  last line carries ``"final": true`` and is bit-for-bit the execute
  answer under the same budget).
- ``GET /v1/tenants/<name>/stats``: that tenant's observability block.
- ``GET /v1/stats``: every tenant + the shared intel plane.
- ``GET /v1/healthz``: liveness.

Status mapping: malformed JSON -> 400, unknown tenant/route -> 404, typed
admission ``Rejection`` -> its own ``status`` (429 rate-limit / 503
queue-full) with a ``Retry-After`` header — the rejection is data, never a
server error. Engine answers (including ``FailedAnswer``) are 200: the
request was served; the outcome is in the body's ``kind``.

Each request runs on its own thread (``ThreadingHTTPServer``), which is
exactly the concurrency the front's admission + engine-lock design expects.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from repro_torch.serving.front.wire import (
    WireError,
    answer_to_json,
    budget_from_json,
    query_from_json,
    report_to_json,
)


class FrontHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer carrying the front for its handlers.

    ``daemon_threads`` so in-flight request threads never block process
    exit; ``allow_reuse_address`` for fast test restarts on one port.
    """

    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, address, front):
        self.front = front
        super().__init__(address, _Handler)


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    # ------------------------------------------------------------- plumbing
    def log_message(self, fmt, *args):  # noqa: D102 — silence default stderr
        pass

    @property
    def front(self):
        return self.server.front

    def _send_json(self, status: int, obj: dict, headers=()):
        body = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _error(self, status: int, message: str):
        self._send_json(status, {"kind": "error", "error": message})

    def _read_body(self) -> dict:
        length = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(length) if length else b"{}"
        try:
            obj = json.loads(raw or b"{}")
        except json.JSONDecodeError as e:
            raise WireError(f"invalid JSON body: {e}") from None
        if not isinstance(obj, dict):
            raise WireError("request body must be a JSON object")
        return obj

    def _route(self):
        """(verb, tenant) for /v1/tenants/<name>/<verb>, or (verb, None)."""
        parts = [p for p in self.path.split("?")[0].split("/") if p]
        if parts[:1] != ["v1"]:
            return None, None
        if len(parts) == 2:
            return parts[1], None  # /v1/stats, /v1/healthz
        if len(parts) == 4 and parts[1] == "tenants":
            return parts[3], parts[2]  # /v1/tenants/<name>/<verb>
        return None, None

    # --------------------------------------------------------------- verbs
    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        verb, tenant = self._route()
        try:
            if verb == "healthz" and tenant is None:
                self._send_json(200, {"ok": True})
            elif verb == "stats":
                self._send_json(200, self.front.stats(tenant))
            else:
                self._error(404, f"no such route: GET {self.path}")
        except KeyError as e:
            self._error(404, str(e))

    def do_POST(self):  # noqa: N802
        verb, tenant = self._route()
        if verb not in ("execute", "explain", "stream") or tenant is None:
            self._error(404, f"no such route: POST {self.path}")
            return
        try:
            body = self._read_body()
            query = query_from_json(self._schema(tenant), body.get("query"))
            budget = budget_from_json(body.get("budget"))
        except WireError as e:
            self._error(400, str(e))
            return
        except KeyError as e:
            self._error(404, str(e))
            return
        if verb == "stream":
            self._stream(tenant, query, budget)
            return
        if verb == "execute":
            ans = self.front.execute(tenant, query, budget=budget)
        else:
            ans = self.front.explain(tenant, query, budget=budget)
        if getattr(ans, "rejected", False):
            self._send_json(
                ans.status, answer_to_json(ans),
                headers=[("Retry-After", f"{ans.retry_after_s:.3f}")])
        elif verb == "explain":
            self._send_json(200, report_to_json(ans))
        else:
            self._send_json(200, answer_to_json(ans))

    def _schema(self, tenant: str):
        return self.front.tenant(tenant).session.schema

    def _stream(self, tenant: str, query, budget):
        """Chunked NDJSON: one answer-ladder object per refinement round."""
        stream = self.front.stream(tenant, query, budget=budget)
        try:
            first = next(stream)
        except StopIteration:
            self._error(500, "stream produced no answers")
            return
        if getattr(first, "rejected", False):
            self._send_json(
                first.status, answer_to_json(first),
                headers=[("Retry-After", f"{first.retry_after_s:.3f}")])
            return
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def write_chunk(obj):
            data = (json.dumps(obj) + "\n").encode()
            self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")

        write_chunk(answer_to_json(first))
        for ans in stream:
            write_chunk(answer_to_json(ans))
        self.wfile.write(b"0\r\n\r\n")


def serve_http(front, host: str = "127.0.0.1", port: int = 0,
               block: bool = False) -> FrontHTTPServer:
    """Serve ``front`` over HTTP; returns the bound server.

    ``port=0`` binds an ephemeral port (``server.server_address``). With
    ``block=False`` (default) the accept loop runs on a daemon thread and
    the caller owns shutdown (``server.shutdown(); server.server_close()``).
    """
    server = FrontHTTPServer((host, port), front)
    if block:
        server.serve_forever()
    else:
        thread = threading.Thread(target=server.serve_forever,
                                  name="serving-front-http", daemon=True)
        thread.start()
    return server
