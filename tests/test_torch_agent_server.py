"""The port's agent REST server (``opsagent_tpu_torch/server``, on the standard
library's threading HTTP server) against the JAX package's aiohttp app, on
the CPU.

The JAX app runs in ``aiohttp.test_utils.TestServer`` on an event loop of its
own thread; both servers are driven over urllib with the same requests.
Every case of tests/test_server.py, and more, gives the same status, JSON
body (the request id and the token aside), ``Content-Type`` and CORS
headers: JWT round trip and errors (the same key, claims and ``iat`` give
byte-equal tokens), login, version, an empty key refusing every token, the
JWT guard, the CORS preflight, ``execute`` end to end with a scripted model
and tool (its trace holds the loop's ``llm_turn`` and ``tool_exec`` spans
under the request's root), a missing API key, bad JSON, the perf and
observability routes, 404 and 405.
"""

import asyncio
import json
import threading
import urllib.error
import urllib.request

import pytest
from aiohttp.test_utils import TestServer

from _torch_agent_kit import PKGS, package, port_state, registries, script  # noqa: F401
from opsagent_tpu.server import jwtauth as jjwt
from opsagent_tpu.server.app import build_app
from opsagent_tpu_torch.server import jwtauth as pjwt
from opsagent_tpu_torch.server.app import build_server

JWT_KEY = "test-key"
CORS = ("Access-Control-Allow-Origin", "Access-Control-Allow-Methods",
        "Access-Control-Allow-Headers")


class JaxApp:
    """The JAX package's app in a TestServer on its own event loop."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()

        async def start():
            server = TestServer(build_app())
            await server.start_server()
            return server

        self.server = asyncio.run_coroutine_threadsafe(start(), self.loop).result(30)
        self.base = str(self.server.make_url("")).rstrip("/")

    def close(self):
        asyncio.run_coroutine_threadsafe(self.server.close(), self.loop).result(30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)


class PortApp:
    def __init__(self):
        self.server = build_server("127.0.0.1", 0)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        self.base = f"http://127.0.0.1:{self.server.server_address[1]}"

    def close(self):
        self.server.shutdown()
        self.server.server_close()


@pytest.fixture(scope="module")
def apps():
    a = {"jax": JaxApp(), "torch": PortApp()}
    yield a
    for app in a.values():
        app.close()


def call(app, path, method="GET", body=None, headers=None, raw=None):
    """(status, headers, body bytes) of one request."""
    data = raw if raw is not None else (None if body is None else json.dumps(body).encode())
    hdrs = {"Content-Type": "application/json"} if data is not None else {}
    hdrs.update(headers or {})
    req = urllib.request.Request(app.base + path, data=data, method=method, headers=hdrs)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


VOLATILE = {"token", "request_id"}


def view(status, headers, data):
    """What must agree between the two servers."""
    ctype = headers.get("Content-Type", "")
    body = data
    if ctype.startswith("application/json"):
        body = json.loads(data)
        if isinstance(body, dict):
            body = {k: v for k, v in body.items() if k not in VOLATILE}
    return status, ctype, body, {h: headers.get(h) for h in CORS}, \
        "X-Request-Id" in headers


def set_globals(**kv):
    for n in PKGS:
        for k, v in kv.items():
            package(n).globalstore.set_global(k, v)


def both(apps, *args, **kw):
    got = {n: call(apps[n], *args, **kw) for n in PKGS}
    views = {n: view(*got[n]) for n in PKGS}
    assert views["torch"] == views["jax"]
    return views["jax"], got


# -- JWT ------------------------------------------------------------------------

@pytest.mark.parametrize("jwt", (jjwt, pjwt), ids=PKGS)
def test_jwt_roundtrip_and_errors(jwt):
    token = jwt.issue_token("admin", JWT_KEY)
    claims = jwt.decode(token, JWT_KEY)
    assert claims["username"] == "admin" and claims["exp"] > claims["iat"]
    for bad in (lambda: jwt.decode(token, "other-key"),
                lambda: jwt.decode(jwt.encode({"username": "x", "exp": 1}, JWT_KEY), JWT_KEY),
                lambda: jwt.decode("not-a-token", JWT_KEY)):
        with pytest.raises(jwt.JWTError):
            bad()


def test_tokens_are_byte_equal(monkeypatch):
    for jwt in (jjwt, pjwt):
        monkeypatch.setattr(jwt.time, "time", lambda: 1700000000.25)
    assert pjwt.issue_token("admin", JWT_KEY) == jjwt.issue_token("admin", JWT_KEY)
    claims = {"username": "ops", "iat": 1, "exp": 99, "extra": ["x", 1]}
    assert pjwt.encode(claims, "k") == jjwt.encode(claims, "k")
    forged = jjwt.encode({"username": "x"}, "k")[:-2] + "AA"
    for jwt in (jjwt, pjwt):
        with pytest.raises(jwt.JWTError, match="invalid signature"):
            jwt.decode(forged, "k")


# -- tests/test_server.py's cases ------------------------------------------------

def test_login_and_version(apps):
    set_globals(jwtKey=JWT_KEY)
    (status, _, body, _, _), got = both(apps, "/login", "POST",
                                        {"username": "admin", "password": "novastar"})
    assert status == 200 and body == {"expires_in": 86400}
    for n in PKGS:
        assert pjwt.decode(json.loads(got[n][2])["token"], JWT_KEY)["username"] == "admin"
    assert both(apps, "/login", "POST", {"username": "admin", "password": "wrong"})[0][0] == 401
    assert both(apps, "/login", "POST", raw=b"{nope")[0][0] == 400
    (status, _, body, _, _), _ = both(apps, "/api/version")
    assert status == 200 and body == {"version": "v0.1.0"}
    assert both(apps, "/healthz")[0][2] == body


def test_empty_jwt_key_rejects_all_tokens(apps):
    forged = pjwt.issue_token("admin", "")
    (status, _, body, _, _), _ = both(apps, "/api/execute", "POST", {"instructions": "x"},
                                      headers={"Authorization": f"Bearer {forged}"})
    assert status == 500 and "not configured" in body["error"]
    assert both(apps, "/login", "POST", {"username": "admin", "password": "novastar"}
                )[0][0] == 500


@pytest.mark.parametrize("method,path", (("POST", "/api/execute"), ("GET", "/api/perf/stats"),
                                         ("GET", "/api/debug/flight"),
                                         ("GET", "/api/trace/abc"), ("POST", "/api/nowhere")))
def test_protected_route_requires_jwt(apps, method, path):
    set_globals(jwtKey=JWT_KEY)
    assert both(apps, path, method, {"instructions": "x"} if method == "POST" else None
                )[0][0] == 401
    for auth in ("Basic abc", "Bearer garbage", f"Bearer {pjwt.issue_token('a', 'other')}"):
        assert both(apps, path, method, headers={"Authorization": auth})[0][0] == 401


@pytest.mark.parametrize("path", ("/api/execute", "/anything/at/all", "/login"))
def test_cors_preflight(apps, path):
    (status, _, _, cors, _), _ = both(apps, path, "OPTIONS")
    assert status == 204 and "X-API-Key" in cors["Access-Control-Allow-Headers"]


def tp(name="", tool_input="", observation="", final="", thought=""):
    return json.dumps({"question": "q", "thought": thought,
                       "action": {"name": name, "input": tool_input},
                       "observation": observation, "final_answer": final})


def span_names(node):
    return [node["name"], [span_names(c) for c in node.get("children", [])]]


@pytest.mark.parametrize("show", ("true", "false", ""))
def test_execute_end_to_end(apps, registries, show):
    set_globals(jwtKey=JWT_KEY)
    for n in PKGS:
        p = package(n)
        registries(p, {"kubectl": lambda c: "default\nkube-system"})
        script(p, [tp("kubectl", "get ns --no-headers", thought="list"),
                   tp(observation="default\nkube-system", thought="count",
                      final="There are 2 namespaces in the cluster.")])
    token = pjwt.issue_token("admin", JWT_KEY)
    headers = {"Authorization": f"Bearer {token}", "X-API-Key": "k"}
    (status, _, body, _, rid_header), got = both(
        apps, f"/api/execute?show-thought={show}", "POST",
        {"instructions": "count namespaces", "args": "", "currentModel": "fake://m"},
        headers=headers)
    assert status == 200 and rid_header
    assert body["status"] == "success"
    assert body["message"] == "There are 2 namespaces in the cluster."
    if show == "true":
        assert body["tools_history"][0]["name"] == "kubectl"
        assert "kube-system" in body["tools_history"][0]["observation"]
    trees = {}
    for n in PKGS:
        rid = json.loads(got[n][2])["request_id"]
        assert got[n][1]["X-Request-Id"] == rid
        status, _, data = call(apps[n], f"/api/trace/{rid}", headers=headers)
        assert status == 200
        trees[n] = span_names(json.loads(data)["root"])
    assert trees["torch"] == trees["jax"]
    assert [c[0] for c in trees["jax"][1]] == ["llm_turn", "tool_exec", "llm_turn"]


def test_execute_request_id_from_the_client(apps, registries):
    set_globals(jwtKey=JWT_KEY)
    for n in PKGS:
        script(package(n), [tp(observation="seen", final="Nothing to do, all healthy.")])
    headers = {"Authorization": f"Bearer {pjwt.issue_token('admin', JWT_KEY)}",
               "X-API-Key": "k", "X-Request-Id": "client-rid-1"}
    (status, _, body, _, _), got = both(apps, "/api/execute", "POST",
                                        {"instructions": "x", "currentModel": "fake://m"},
                                        headers=headers)
    assert status == 200
    for n in PKGS:
        assert json.loads(got[n][2])["request_id"] == "client-rid-1"


@pytest.mark.parametrize("body,headers,want", (
    ({"instructions": "x", "args": ""}, {}, 400),                    # no API key
    ({"args": ""}, {"X-API-Key": "k"}, 400),                         # no instructions
    (None, {"X-API-Key": "k"}, 400),                                 # not JSON
))
def test_execute_refusals(apps, body, headers, want):
    set_globals(jwtKey=JWT_KEY)
    hdrs = {"Authorization": f"Bearer {pjwt.issue_token('admin', JWT_KEY)}", **headers}
    (status, _, resp, _, _), _ = both(apps, "/api/execute", "POST", body, headers=hdrs,
                                      raw=b"{not json" if body is None else None)
    assert status == want and "error" in resp


def test_execute_agent_failure_and_anonymous_llm(apps, registries):
    set_globals(jwtKey=JWT_KEY, allowAnonymousLLM=True)
    hdrs = {"Authorization": f"Bearer {pjwt.issue_token('admin', JWT_KEY)}"}
    (status, _, body, _, _), _ = both(apps, "/api/execute", "POST",
                                      {"instructions": "x", "currentModel": "nosuch://m"},
                                      headers=hdrs)
    assert status == 500 and body["error"].startswith("agent failed: no provider registered")


@pytest.mark.parametrize("path,body", (("/api/diagnose", {}), ("/api/diagnose", {"pod": "web"}),
                                       ("/api/analyze", {}),
                                       ("/api/analyze", {"name": "web"})))
def test_diagnose_and_analyze(apps, registries, path, body, monkeypatch, tmp_path):
    set_globals(jwtKey=JWT_KEY)
    monkeypatch.setenv("KUBECONFIG", str(tmp_path / "missing"))
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    for n in PKGS:
        script(package(n), [tp(observation="seen", final="The pod web is healthy and ready.")])
    hdrs = {"Authorization": f"Bearer {pjwt.issue_token('admin', JWT_KEY)}", "X-API-Key": "k"}
    (status, _, resp, _, _), _ = both(apps, path, "POST",
                                      {**body, "currentModel": "fake://m"}, headers=hdrs)
    if not body:
        assert status == 400
    elif path == "/api/diagnose":
        assert status == 200 and resp["message"] == "The pod web is healthy and ready."
    else:
        assert status == 500 and "no kubeconfig found" in resp["error"]


def test_perf_endpoints(apps):
    set_globals(jwtKey=JWT_KEY)
    hdrs = {"Authorization": f"Bearer {pjwt.issue_token('admin', JWT_KEY)}"}
    (status, _, body, _, _), _ = both(apps, "/api/perf/reset", "POST", headers=hdrs)
    assert status == 200 and body == {"status": "reset"}
    got = {n: call(apps[n], "/api/perf/stats", headers=hdrs) for n in PKGS}
    for n in PKGS:
        assert got[n][0] == 200 and "stats" in json.loads(got[n][2])


@pytest.mark.parametrize("path", ("/api/slo", "/api/metrics/history",
                                  "/api/metrics/history?series=nope&since=x",
                                  "/api/debug/flight?n=x", "/api/debug/flight?n=2&kind=none",
                                  "/api/trace/unknown", "/api/timeline/unknown",
                                  "/api/debug/memory", "/api/debug/profile?seconds=x",
                                  "/api/debug/profile?seconds=1"))
def test_observability_routes(apps, path, monkeypatch):
    set_globals(jwtKey=JWT_KEY)
    monkeypatch.delenv("OPSAGENT_PROFILE_DIR", raising=False)
    hdrs = {"Authorization": f"Bearer {pjwt.issue_token('admin', JWT_KEY)}"}
    method = "POST" if "profile" in path else "GET"
    got = {n: call(apps[n], path, method, headers=hdrs) for n in PKGS}
    (js, jh, jb), (ps, ph, pb) = got["jax"], got["torch"]
    assert ps == js and ph["Content-Type"] == jh["Content-Type"]
    if path in ("/api/slo", "/api/metrics/history"):
        assert sorted(json.loads(pb)) == sorted(json.loads(jb))
    elif js != 200:
        assert json.loads(pb) == json.loads(jb)


def test_metrics_route(apps):
    both(apps, "/api/version")
    got = {n: call(apps[n], "/metrics") for n in PKGS}
    for n in PKGS:
        status, headers, data = got[n]
        assert status == 200 and headers["Content-Type"] == "text/plain; charset=utf-8"
        assert "opsagent_http_requests_total" in data.decode()


@pytest.mark.parametrize("method,path", (("GET", "/nowhere"), ("GET", "/login"),
                                         ("POST", "/api/version")))
def test_unknown_paths_and_methods(apps, method, path):
    set_globals(jwtKey=JWT_KEY)
    hdrs = {"Authorization": f"Bearer {pjwt.issue_token('admin', JWT_KEY)}"}
    (status, ctype, body, cors, rid), got = both(apps, path, method, headers=hdrs)
    assert status in (404, 405) and ctype.startswith("text/plain") and not rid
    if status == 405:
        assert got["torch"][1]["Allow"] == got["jax"][1]["Allow"]
