"""The agent's REST server on the standard library's threading HTTP server
(the port's counterpart of ``opsagent_tpu/server/app.py``, which runs on
aiohttp; the machine beside the card has none).

Routes: ``POST /login``, ``GET /api/version`` and ``/healthz``, ``POST
/api/execute``, ``/api/diagnose`` and ``/api/analyze``, ``GET
/api/perf/stats``, ``POST /api/perf/reset``, ``GET /metrics``, and the
engine server's observability routes (``GET /api/trace/{id}``,
``/api/timeline/{id}``, ``/api/debug/flight``, ``/api/debug/memory``,
``/api/slo``, ``/api/metrics/history``, ``POST /api/debug/profile``).

Around every request, in the JAX app's middleware order:

- recovery: a handler that raises answers 500 ``{"error": "internal server
  error"}`` (no CORS headers, as aiohttp's exception path has none);
- CORS: ``OPTIONS`` on any path answers 204 with the CORS headers, every
  other answer carries them;
- logging: the request id (``X-Request-Id``, else a new one) roots the
  request's trace and comes back in ``X-Request-Id``; each answer counts in
  ``opsagent_http_requests_total{method,path,status}`` and
  ``opsagent_http_request_duration_seconds{path}`` by its path;
- JWT: ``/api/*`` outside ``PUBLIC_PATHS`` needs ``Authorization: Bearer``
  with a token signed by the configured key; an empty key rejects every
  token.

An unknown path answers 404 and a known path under another method 405, in
aiohttp's plain-text form; ``HEAD`` is answered where ``GET`` is.
"""

from __future__ import annotations

import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any
from urllib.parse import parse_qs, urlsplit

from .. import obs
from ..serving.api import ObsRoutes, compile_routes, find_route
from ..utils.globalstore import get_global
from ..utils.logger import get_logger
from ..utils.perf import get_perf_stats
from . import handlers
from .handlers import Request, Response, json_response
from .jwtauth import JWTError, decode

log = get_logger("api")

CORS_HEADERS = {
    "Access-Control-Allow-Origin": "*",
    "Access-Control-Allow-Methods": "GET, POST, PUT, DELETE, OPTIONS",
    "Access-Control-Allow-Headers": (
        "Origin, Content-Type, Content-Length, Accept-Encoding, "
        "Authorization, X-API-Key, X-Requested-With"
    ),
}

# /api/slo and /api/metrics/history are public like /metrics: read-only
# summaries a CI gate or prober reads without credentials. The flight ring
# and profile capture stay behind the JWT: event attrs can carry request
# payloads.
PUBLIC_PATHS = {
    "/login", "/api/version", "/healthz", "/metrics", "/api/slo",
    "/api/metrics/history",
}

MAX_BODY_BYTES = 16 * 1024 * 1024

ROUTES = (
    ("POST", "/login", "login"),
    ("GET", "/api/version", "version"),
    ("GET", "/healthz", "version"),
    ("POST", "/api/execute", "execute"),
    ("POST", "/api/diagnose", "diagnose"),
    ("POST", "/api/analyze", "analyze"),
    ("GET", "/api/perf/stats", "perf_stats"),
    ("POST", "/api/perf/reset", "perf_reset"),
    ("GET", "/metrics", "metrics"),
    ("GET", "/api/trace/{request_id}", "trace_get"),
    ("GET", "/api/timeline/{request_id}", "timeline_get"),
    ("GET", "/api/debug/flight", "flight_get"),
    ("GET", "/api/debug/memory", "memory_profile"),
    ("GET", "/api/slo", "slo_get"),
    ("GET", "/api/metrics/history", "history_get"),
    ("POST", "/api/debug/profile", "profile_capture"),
)
_COMPILED = compile_routes(ROUTES)
# Routes answered by handlers.py; the rest are ObsRoutes methods.
_HANDLERS = {"login", "version", "execute", "diagnose", "analyze", "perf_stats",
             "perf_reset", "metrics"}


def _text(status: int, reason: str, **headers: str) -> Response:
    """aiohttp's plain-text answer to an HTTP error raised by routing."""
    return Response(status, f"{status}: {reason}".encode(), "text/plain; charset=utf-8",
                    dict(headers))


class _Handler(ObsRoutes, BaseHTTPRequestHandler):
    # The JAX agent app's observability error bodies.
    HISTORY_ERROR = "{}"
    PROFILE_OFF = ("profiling not enabled: start the server with --profile-dir "
                   "(or set OPSAGENT_PROFILE_DIR)")
    PROFILE_DENIED = (RuntimeError,)

    _response: Response | None = None

    # -- ObsRoutes' writers: collect the answer for the middleware ---------
    def _reply(self, status: int, payload: Any) -> None:
        self._response = json_response(payload, status)

    def _error(self, status: int, message: str) -> None:
        self._reply(status, {"error": message})

    def _write(self, resp: Response) -> None:
        self.send_response(resp.status)
        if resp.content_type:
            self.send_header("Content-Type", resp.content_type)
        self.send_header("Content-Length", str(len(resp.body)))
        for k, v in resp.headers.items():
            self.send_header(k, v)
        self.end_headers()
        if self.command != "HEAD":
            self.wfile.write(resp.body)

    def _read_body(self) -> bytes:
        length = int(self.headers.get("Content-Length") or 0)
        if length > MAX_BODY_BYTES:
            raise ValueError("request body too large")
        return self.rfile.read(length) if length > 0 else b""

    def _route(self, method: str, path: str, query: dict[str, str], rid: str) -> Response:
        """JWT, then the handler's answer; ``_RoutingError`` where no route
        takes the request."""
        if path not in PUBLIC_PATHS and path.startswith("/api/"):
            auth = self.headers.get("Authorization", "")
            if not auth.startswith("Bearer "):
                return json_response(
                    {"error": "missing or malformed Authorization header"}, status=401)
            key = get_global("jwtKey", "")
            if not key:
                # Never verify with an empty HMAC key: anyone could forge
                # tokens signed with "".
                return json_response({"error": "server JWT key not configured"}, status=500)
            try:
                decode(auth[len("Bearer "):], key)
            except JWTError as e:
                return json_response({"error": f"invalid token: {e}"}, status=401)
        handler, params, label = find_route(_COMPILED, "GET" if method == "HEAD" else method,
                                            path)
        if handler is None:
            raise _RoutingError(label)
        if handler in _HANDLERS:
            req = Request(method, path, query, self.headers, self._read_body(), rid)
            return getattr(handlers, handler)(req)
        self._response = None
        getattr(self, handler)(query, **params)
        assert self._response is not None
        return self._response

    def _dispatch(self, method: str) -> None:
        url = urlsplit(self.path)
        path = url.path
        query = {k: v[0] for k, v in parse_qs(url.query, keep_blank_values=True).items()}
        if method == "OPTIONS":
            self._write(Response(204, headers=dict(CORS_HEADERS)))
            return
        try:
            rid = self.headers.get("X-Request-Id") or obs.new_request_id()
            t0 = time.perf_counter()
            with get_perf_stats().timer(f"http.{method}.{path}"):
                resp = self._route(method, path, query, rid)
            dt = time.perf_counter() - t0
            obs.HTTP_REQUESTS.inc(method=method, path=path, status=str(resp.status))
            obs.HTTP_LATENCY_SECONDS.observe(dt, path=path)
            resp.headers["X-Request-Id"] = rid
            log.info("%s %s -> %d", method, path, resp.status,
                     extra={"fields": {"remote": self.client_address[0], "request_id": rid}})
            resp.headers.update(CORS_HEADERS)
        except _RoutingError as e:
            if e.label == "unmatched":
                resp = _text(404, "Not Found")
            else:
                allowed = {m for m, pattern, _, _ in _COMPILED if pattern == e.label}
                allowed |= {"HEAD"} if "GET" in allowed else set()
                resp = _text(405, "Method Not Allowed", Allow=",".join(sorted(allowed)))
        except Exception:  # noqa: BLE001 - the recovery boundary
            log.exception("panic in handler %s %s", method, path)
            resp = json_response({"error": "internal server error"}, status=500)
        self._write(resp)

    def do_GET(self) -> None:  # noqa: N802 - http.server's name
        self._dispatch("GET")

    def do_HEAD(self) -> None:  # noqa: N802 - http.server's name
        self._dispatch("HEAD")

    def do_POST(self) -> None:  # noqa: N802 - http.server's name
        self._dispatch("POST")

    def do_OPTIONS(self) -> None:  # noqa: N802 - http.server's name
        self._dispatch("OPTIONS")

    def log_message(self, fmt: str, *args: Any) -> None:
        log.debug("%s " + fmt, self.address_string(), *args)


class _RoutingError(Exception):
    def __init__(self, label: str):
        super().__init__(label)
        self.label = label


def build_server(host: str = "0.0.0.0", port: int = 8080) -> ThreadingHTTPServer:
    """The agent server bound to (host, port); port 0 picks a free one (read
    it from ``server.server_address``). Each request runs on its own
    thread."""
    return ThreadingHTTPServer((host, port), _Handler)


def run_server(host: str = "0.0.0.0", port: int = 8080) -> None:
    """Serve until interrupted, with the SLO watchdog behind ``/api/slo``
    and the telemetry history sampler behind ``/api/metrics/history``."""
    server = build_server(host, port)
    watchdog, history = obs.slo.get_watchdog(), obs.history.get_history()
    watchdog.start()
    history.start()
    log.info("opsagent server listening on %s:%d", host, port)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        history.stop()
        watchdog.stop()
