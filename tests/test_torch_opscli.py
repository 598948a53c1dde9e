"""The port's operator commands against the JAX package's, on the CPU, from
the same inputs: ``top --frames 1 --no-color``, ``fleet-kv``,
``fleet-flight`` and ``timeline`` (plain and a router's stitched one)
render the same text; ``perf-check`` (files, and a router's ``GET
/api/fleet/bench``) and ``slo-check`` (a router's ``/api/slo``, a bench
file, one class) give the same exit code and output. Tolerance: exact.

The inputs: the JSON a port router over two port replicas answered after
some traffic, frozen and served by a stub server to both packages' CLIs,
and the committed ``BENCH_r04_local.jsonl``.
"""

import io
import json
import threading
import time
from contextlib import redirect_stderr, redirect_stdout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from _torch_fleet_kit import (  # noqa: F401 - port_state is an autouse fixture
    PKGS, call, close, fleet, package, port_state, serve_router)

BENCH = "BENCH_r04_local.jsonl"
PATHS = ("/api/fleet", "/api/slo", "/api/metrics/history", "/api/fleet/bench",
         "/api/fleet/directory", "/api/fleet/flight")


def _cli(name):
    if name == "jax":
        from opsagent_tpu.cli import main as m
    else:
        from opsagent_tpu_torch.cli import main as m
    return m


@pytest.fixture(scope="module")
def frozen():
    """{path: JSON} of a port router after traffic, and a stitched and a
    plain timeline."""
    from opsagent_tpu_torch import obs

    pkg = package("torch")
    router, stacks = fleet(pkg)
    url, stop = serve_router(pkg, router)
    try:
        for i, content in enumerate(("first", "second", "third")):
            call(url, "/v1/chat/completions",
                 {"messages": [{"role": "user", "content": content}], "max_tokens": 6,
                  "temperature": 0, **({"slo_class": "batch"} if i == 2 else {})})
        _, _, resp = call(url, "/v1/chat/completions",
                          {"messages": [{"role": "user", "content": "timeline me"}],
                           "max_tokens": 6, "temperature": 0})
        obs.flight.anomaly("request_error", error="frozen for the cockpit")
        h = obs.history.get_history()
        h.sample(now=time.time() - 2.0)
        h.sample()
        data = {}
        for path in PATHS:
            _, _, data[path] = call(url, path + ("?n=64" if "flight" in path else ""))
        _, _, data["stitched"] = call(url, f"/api/timeline/{resp['id']}")
        data["plain"] = obs.timeline.assemble(resp["id"])
        return data
    finally:
        stop()
        close(stacks)


@pytest.fixture
def stub(frozen):
    """A server answering the frozen JSON on every path it holds (the query
    string is ignored); its base URL."""

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802
            path = self.path.split("?")[0]
            if path.startswith("/api/timeline/"):
                body = frozen["stitched"]
            elif path.startswith("/api/fleet/flight"):
                body = frozen["/api/fleet/flight"]
            else:
                body = frozen.get(path)
            data = json.dumps(body).encode()
            self.send_response(200 if body is not None else 404)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *a):
            pass

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()


class FrozenTime:
    """The cockpit's clock: a fixed wall time and stamp."""

    def __init__(self, wall):
        self.wall = wall

    def time(self):
        return self.wall

    def strftime(self, fmt, *a):
        return "12:00:00"

    def sleep(self, s):
        pass


def _run(name, argv) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = _cli(name).main(argv)
    return rc, out.getvalue(), err.getvalue()


def _both(argv) -> dict:
    return {name: _run(name, list(argv)) for name in PKGS}


def test_top_frame_equals_jax(stub, frozen, monkeypatch):
    from opsagent_tpu.cli import top as jtop
    from opsagent_tpu_torch.cli import top as ptop

    wall = max(e.get("wall", 0.0) for e in frozen["/api/fleet/flight"]["events"]) + 5.0
    for mod in (jtop, ptop):
        monkeypatch.setattr(mod, "time", FrozenTime(wall))
    got = _both(["top", "--url", stub, "--frames", "1", "--no-color"])
    assert got["torch"] == got["jax"]
    rc, out, _ = got["torch"]
    assert rc == 0 and "opsagent top" in out and "r0" in out and "r1" in out


@pytest.mark.parametrize("argv", [["fleet-kv"], ["fleet-kv", "--json"],
                                  ["fleet-flight"], ["fleet-flight", "--kind", "anomaly"],
                                  ["fleet-flight", "--json", "--n", "0"]],
                         ids=["fleet-kv", "fleet-kv-json", "fleet-flight", "fleet-flight-kind",
                              "fleet-flight-json"])
def test_fleet_commands_render_equal_to_jax(stub, argv):
    got = _both(argv + ["--url", stub])
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == 0 and got["torch"][1]


def test_fleet_commands_unreachable_router_equal_to_jax():
    for cmd in ("fleet-kv", "fleet-flight"):
        got = _both([cmd, "--url", "http://127.0.0.1:9"])
        assert got["torch"] == got["jax"] and got["torch"][0] == 1


@pytest.mark.parametrize("which", ["plain", "stitched"])
def test_timeline_renders_equal_to_jax(frozen, tmp_path, stub, which):
    path = tmp_path / "tl.json"
    path.write_text(json.dumps(frozen[which]))
    for extra in (["--file", str(path)], ["--file", str(path), "--width", "40"],
                  ["--url", stub], ["--file", str(path), "--json"]):
        if which == "plain" and extra[0] == "--url":
            continue
        got = _both(["timeline", "chatcmpl-x", *extra])
        assert got["torch"] == got["jax"], extra
        assert got["torch"][0] == 0 and got["torch"][1]
    if which == "stitched":
        assert frozen["stitched"]["fleet"]


def test_perf_check_equals_jax(tmp_path, stub):
    rows = [json.loads(line) for line in open(BENCH)]
    worse = tmp_path / "worse.jsonl"
    worse.write_text("\n".join(json.dumps(dict(r, value=r["value"] * 0.5)) for r in rows))
    same = tmp_path / "same.jsonl"
    same.write_text("\n".join(json.dumps(r) for r in rows))
    tol = tmp_path / "tol.json"
    tol.write_text(json.dumps({"bench-8b": 0.6}))
    cases = ([str(same), "--baseline", BENCH], [str(worse), "--baseline", BENCH],
             [str(worse), "--baseline", BENCH, "--tolerances", str(tol)],
             [str(worse), "--baseline", BENCH, "--tolerance", "0.6"],
             [str(tmp_path / "missing.jsonl"), "--baseline", BENCH],
             [stub, "--baseline", BENCH])
    codes = []
    for case in cases:
        got = _both(["perf-check", *case])
        assert got["torch"] == got["jax"], case
        codes.append(got["torch"][0])
    assert codes[:2] == [0, 1] and codes[4] == 2


def test_slo_check_equals_jax(tmp_path, stub):
    bench = tmp_path / "bench.jsonl"
    bench.write_text(json.dumps({"metric": "m", "value": 1.0, "extra": {"slo": {
        "slos": [{"name": "ttft_p95", "value": 120.0, "target": 500.0, "unit": "ms",
                  "pass": True}]}}}) + "\n")
    codes = []
    for case in (["--url", stub], ["--bench", str(bench)], ["--url", stub, "--class", "batch"],
                 ["--url", stub, "--class", "background"], ["--url", "http://127.0.0.1:9"]):
        got = _both(["slo-check", *case])
        assert got["torch"] == got["jax"], case
        codes.append(got["torch"][0])
    assert codes[1] == 0 and codes[-1] == 2
