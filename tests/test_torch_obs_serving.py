"""The port's observability wired through its engine, scheduler and HTTP
server, against the JAX package's serving stack on the CPU.

``tiny-test`` in f32 with the JAX engine's weights on both sides
(``params_from_jax``), greedy, byte tokenizer.

- The port's engine and the JAX engine serve the same greedy requests
  through their ``ServingStack``: ``opsagent_engine_requests_total{outcome}``,
  ``opsagent_decode_tokens_total``, prefill plus prefix-hit tokens, the
  TTFT, inter-token-latency and queue-wait counts and the per-class request
  counts are equal, and each completion's trace has JAX's span names.
- ``Engine.warmup()`` leaves every counter and histogram outside the
  compile family at zero, and nothing records inside a step body.
- Every route the port adds answers with JAX's status codes and bodies over
  HTTP: ``/v1/models``, ``/healthz`` (key set and value types),
  ``/metrics`` (both pass the exposition grammar), ``/api/trace`` and
  ``/api/timeline`` (404 for an unknown id), ``/api/debug/flight`` (400 for
  a bad ``n``), ``/api/slo``, ``/api/metrics/history``, and the profiling
  routes (403 without a profile directory, 400 for a bad duration, 409 for
  a capture already running or none to stop).
"""

import asyncio
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_obs import conform, reset_port_obs

from opsagent_tpu import obs as jobs
from opsagent_tpu.serving.api import ServingStack as JaxStack
from opsagent_tpu.serving.api import build_engine_app
from opsagent_tpu.serving.engine import Engine as JaxEngine
from opsagent_tpu.serving.engine import EngineConfig as JaxEngineConfig
from opsagent_tpu_torch import obs as pobs
from opsagent_tpu_torch.models.config import TINY_TEST
from opsagent_tpu_torch.models.convert import params_from_jax
from opsagent_tpu_torch.models.llama import Llama
from opsagent_tpu_torch.serving.api import ROUTES, ServingStack, make_server
from opsagent_tpu_torch.serving.engine import Engine, EngineConfig

KW = dict(page_size=8, num_pages=1024, max_pages_per_seq=128, max_batch_size=4)
JAX_KW = dict(model="tiny-test", dtype=jnp.float32, tp=1, prefill_buckets=(16, 64), **KW)
# The compile family: the only counters a warmup may move.
COMPILE_FAMILY = {"opsagent_xla_compiles_total", "opsagent_xla_compile_seconds",
                  "opsagent_compile_cache_events_total"}


@pytest.fixture(autouse=True)
def clean_port_obs(tmp_path, monkeypatch):
    monkeypatch.setenv("OPSAGENT_FLIGHT_DIR", str(tmp_path / "flight"))
    monkeypatch.delenv("OPSAGENT_PROFILE_DIR", raising=False)
    reset_port_obs()
    yield
    reset_port_obs()


def serve_aiohttp(app):
    """The JAX package's aiohttp app on 127.0.0.1 in a thread of its own:
    (base URL, stop)."""
    from aiohttp import web

    loop = asyncio.new_event_loop()
    runner = web.AppRunner(app)
    loop.run_until_complete(runner.setup())
    site = web.TCPSite(runner, "127.0.0.1", 0)
    loop.run_until_complete(site.start())
    port = site._server.sockets[0].getsockname()[1]
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    def stop():
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=10)
        loop.run_until_complete(runner.cleanup())
        loop.close()

    return f"http://127.0.0.1:{port}", stop


@pytest.fixture(scope="module")
def stacks():
    """(JAX stack, port stack, JAX base URL, port base URL)."""
    jeng = JaxEngine(JaxEngineConfig(**JAX_KW))
    model = Llama(TINY_TEST, torch.float32, "cpu", seed=None)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jeng.params),
                                          TINY_TEST))
    jstack = JaxStack(jeng, restart_tolerant=False)
    stack = ServingStack(Engine(EngineConfig(model="tiny-test", dtype=torch.float32,
                                             device="cpu", decode_block=8, seed=0, **KW),
                                model=model))
    srv = make_server(stack, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    jbase, jstop = serve_aiohttp(build_engine_app(jstack))
    yield jstack, stack, jbase, f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    stack.close()
    jstop()
    jstack.close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def call(base, path, method="GET", body=None):
    """(status, content type, body: JSON where it parses, else text)."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            status, ctype, raw = r.status, r.headers["Content-Type"], r.read().decode()
    except urllib.error.HTTPError as e:
        status, ctype, raw = e.code, e.headers["Content-Type"], e.read().decode()
    try:
        return status, ctype, json.loads(raw)
    except ValueError:
        return status, ctype, raw


def body(prompt: str, max_tokens: int = 10, **kw):
    return {"messages": [{"role": "user", "content": prompt}], "max_tokens": max_tokens,
            "temperature": 0, **kw}


def counts(pkg) -> dict:
    out = {f"requests_{o}": pkg.ENGINE_REQUESTS.value(outcome=o)
           for o in ("completed", "error", "timeout", "admission_failed")}
    out.update(
        decode_tokens=pkg.DECODE_TOKENS.value(),
        prompt_tokens=pkg.PREFILL_TOKENS.value() + pkg.PREFIX_HIT_TOKENS.value(),
        ttft=pkg.TTFT_SECONDS.count(), itl=pkg.ITL_SECONDS.count(),
        queue_wait=pkg.QUEUE_WAIT_SECONDS.count(),
        class_completed=pkg.CLASS_REQUESTS.value(**{"class": "interactive",
                                                    "outcome": "completed"}),
    )
    return out


# (bodies sent one after another): distinct prompts; a shared prefix that
# the second and third requests hit; n = 2 choices of one prompt.
BATCHES = {
    "distinct": [body("list the pods"), body("describe node worker-3", 14)],
    "shared_prefix": [body("p" * 40 + " first"), body("p" * 40 + " second", 6),
                      body("p" * 40 + " third", 3)],
    "choices": [body("scan the image", 8, n=2)],
    "batch_class": [body("audit the cluster", 5, slo_class="batch")],
}


@pytest.mark.parametrize("batch", sorted(BATCHES))
def test_engines_record_the_same_counts(stacks, batch):
    jstack, stack, _, _ = stacks
    replies = []
    for b in BATCHES[batch]:
        replies.append((jstack.chat_completion(dict(b)), stack.chat_completion(dict(b))))
    for jr, pr in replies:
        assert [c["message"] for c in pr["choices"]] == [c["message"] for c in jr["choices"]]
        assert pr["usage"] == jr["usage"]
    got, want = counts(pobs), counts(jobs)
    assert got == want
    completion = sum(pr["usage"]["completion_tokens"] for _, pr in replies)
    prompt = sum(pr["usage"]["prompt_tokens"] * len(pr["choices"]) for _, pr in replies)
    requests = sum(len(pr["choices"]) for _, pr in replies)
    assert got["decode_tokens"] == completion and got["prompt_tokens"] == prompt
    assert got["ttft"] == got["requests_completed"] == requests
    assert got["itl"] == completion - requests
    if batch == "batch_class":
        for pkg in (jobs, pobs):
            assert pkg.CLASS_REQUESTS.value(**{"class": "batch", "outcome": "completed"}) == 1
    if batch == "shared_prefix":
        assert pobs.PREFIX_HIT_TOKENS.value() == jobs.PREFIX_HIT_TOKENS.value() > 0


def span_names(node, depth=0, out=None):
    out = out if out is not None else {}
    out.setdefault(depth, set()).add(node["name"])
    for c in node.get("children", ()):
        span_names(c, depth + 1, out)
    return out


@pytest.mark.parametrize("stream", [False, True])
def test_completion_traces_have_the_jax_spans(stacks, stream):
    jstack, stack, _, _ = stacks
    b = body("get the logs", 12)
    if stream:
        jcid = [c for c in jstack.chat_completion_stream(dict(b))][0]["id"]
        pcid = [c for c in stack.chat_completion_stream(dict(b))][0]["id"]
    else:
        jcid = jstack.chat_completion(dict(b))["id"]
        pcid = stack.chat_completion(dict(b))["id"]
    assert pcid.startswith("chatcmpl-")
    jt, pt = jobs.get_trace(jcid), pobs.get_trace(pcid)
    assert sorted(pt) == sorted(jt)
    jn, pn = span_names(jt["root"]), span_names(pt["root"])
    for depth in (0, 1, 2):
        assert pn[depth] == jn[depth]
    assert {"queue_wait", "prefill", "decode"} <= pn[2]
    assert pn[1] == ({"generate"} if stream else {"generate", "detokenize"})
    jtl, ptl = jobs.timeline.assemble(jcid), pobs.timeline.assemble(pcid)
    assert sorted(ptl) == sorted(jtl)
    assert {p["phase"] for p in ptl["phases"]} >= {"queued", "prefill", "decode_active"}
    assert abs(sum(p["duration_ms"] for p in ptl["phases"]) - ptl["duration_ms"]) \
        <= 0.05 * ptl["duration_ms"]
    kinds = {e["kind"] for e in pobs.flight.get_recorder().snapshot()}
    assert {"admission", "dispatch", "ttft", "finish"} <= kinds


def test_warmup_leaves_every_non_compile_counter_at_zero():
    eng = Engine(EngineConfig(model="tiny-test", dtype=torch.float32, device="cpu",
                              decode_block=4, **KW))
    reset_port_obs()
    eng.warmup()
    for name, m in pobs.get_registry()._metrics.items():
        if m.kind == "gauge" or name in COMPILE_FAMILY:
            continue
        with m._lock:
            children = dict(m._children)
        assert not children, name
    assert [e["kind"] for e in pobs.flight.get_recorder().snapshot()] == ["warmup"]
    assert pobs.flight.warmed()
    # A request after warmup records once per tick and block, on the host.
    eng.generate([[257, 5, 6, 7, 8]])
    assert pobs.DECODE_DISPATCHES.value(kind="mixed") == 1
    assert pobs.DECODE_DISPATCHES.value(kind="block") >= 1
    assert pobs.POST_WARMUP_COMPILES.value() == 0


def test_engine_gauges_and_attribution_after_a_request():
    eng = Engine(EngineConfig(model="tiny-test", dtype=torch.float32, device="cpu",
                              decode_block=4, **KW))
    assert eng.weight_stream_impl == "xla"
    assert pobs.attribution.current() is eng.attr
    toks = eng.generate([[257] + list(range(3, 40))])[0]
    assert pobs.DECODE_TOKENS.value() == len(toks)
    assert pobs.KV_PAGES_FREE.value() == eng.alloc.free_pages
    assert pobs.RUNNING_SEQUENCES.value() == 0
    snap = pobs.attribution.snapshot()
    assert snap["dispatches"] == pobs.DECODE_DISPATCHES.value(kind="mixed") + \
        pobs.DECODE_DISPATCHES.value(kind="block")
    assert snap["bytes_by_kind"]["weights"] > 0 and snap["drift_ema"] > 0
    # The admission's synchronous mixed tick is a measured step; a pipelined
    # block is enqueued, not waited for, so none is (as in JAX).
    assert pobs.attribution.ATTR_MEASURED_STEP_SECONDS.count(op="mixed") >= 1
    assert pobs.attribution.ATTR_MEASURED_STEP_SECONDS.count(op="block") == 0


# -- routes over HTTP ------------------------------------------------------------
def test_every_jax_engine_route_but_fleet_is_served():
    from opsagent_tpu.serving import api as japi

    app = japi.build_engine_app(_FakeJaxStack())
    jax_routes = {(r.method, r.resource.canonical) for r in app.router.routes()
                  if r.method != "HEAD"}
    port_routes = {(m, p) for m, p, _ in ROUTES}
    # Every route, /fleet/drain and /fleet/promote included since the
    # port's fleet router came (the test keeps its earlier name).
    assert port_routes == jax_routes


class _FakeJaxStack:
    model_name = "tiny-test"
    engine = None


# (method, path, what must match): "all" = status and body, "status" =
# status only, "keys" = status and the body's keys.
NO_DIR = [
    ("GET", "/v1/models", "models"),
    ("GET", "/healthz", "healthz"),
    ("GET", "/metrics", "metrics"),
    ("GET", "/api/trace/chatcmpl-unknown", "all"),
    ("GET", "/api/timeline/chatcmpl-unknown", "all"),
    ("GET", "/api/debug/flight?n=bogus", "all"),
    ("GET", "/api/debug/flight?n=2&kind=admission", "keys"),
    ("GET", "/api/slo", "keys"),
    ("GET", "/api/metrics/history?since=bogus", "all"),
    ("GET", "/api/metrics/history?series=decode_tokens&since=60&step=5", "keys"),
    ("GET", "/api/debug/memory", "all"),
    ("POST", "/api/debug/profile?seconds=1", "all"),
    ("POST", "/api/debug/profile?seconds=0", "all"),
    ("POST", "/api/debug/profile?seconds=abc", "all"),
    ("POST", "/v1/profile/start", "all"),
    ("POST", "/v1/profile/stop", "status"),
    ("GET", "/no/such/route", "status"),
    ("POST", "/healthz", "status"),
]


@pytest.mark.parametrize("method,path,match", NO_DIR)
def test_routes_answer_as_jax_does(stacks, method, path, match):
    _, _, jbase, pbase = stacks
    js, jct, jb = call(jbase, path, method)
    ps, pct, pb = call(pbase, path, method)
    assert ps == js
    if match == "all":
        assert pb == jb
    elif match == "keys":
        assert sorted(pb) == sorted(jb)
    elif match == "models":
        for d in (pb, jb):
            d["data"][0].pop("owned_by")
        assert pb == jb
    elif match == "healthz":
        # Both engines run async mixed ticks at depth 2: both carry "async".
        optional = {"fleet", "faults"}
        assert set(pb) == set(jb) - optional
        assert set(jb["init"]) <= set(pb["init"]) | {"warmup_groups"}
        for k, v in pb.items():
            assert type(v) is type(jb[k]), k
        assert pb["async"] == jb["async"] == {"depth": 2, "inflight": 0}
        assert pb["impl"]["attn_impl"] == "plain" and pb["queued"] == 0
    elif match == "metrics":
        assert ps == 200 and pct.startswith("text/plain") and jct.startswith("text/plain")
        conform(pb)
        conform(jb)


def test_trace_and_timeline_routes_of_a_completion(stacks):
    _, _, jbase, pbase = stacks
    ids = {}
    for name, base in (("jax", jbase), ("port", pbase)):
        status, _, reply = call(base, "/v1/chat/completions", "POST", body("top pods", 6))
        assert status == 200
        ids[name] = reply["id"]
    out = {}
    for name, base in (("jax", jbase), ("port", pbase)):
        out[name] = [call(base, f"/api/{r}/{ids[name]}") for r in ("trace", "timeline")]
        flight = call(base, "/api/debug/flight?kind=dispatch&n=1")[2]
        assert len(flight["events"]) == 1
    for (js, _, jb), (ps, _, pb) in zip(out["jax"], out["port"]):
        assert ps == js == 200 and sorted(pb) == sorted(jb)
        assert pb["request_id"] == ids["port"]
    assert pobs.HTTP_REQUESTS.value(method="GET", path="/api/trace/{request_id}",
                                    status="200") == 1
    assert pobs.HTTP_LATENCY_SECONDS.count(path="/v1/chat/completions") == 1


@pytest.mark.parametrize("route", ["capture", "start_stop"])
def test_profile_routes_with_a_directory(stacks, route, tmp_path, monkeypatch):
    _, _, jbase, pbase = stacks
    for name, base in (("jax", jbase), ("port", pbase)):
        logdir = tmp_path / name
        monkeypatch.setenv("OPSAGENT_PROFILE_DIR", str(logdir))
        if route == "capture":
            status, _, b = call(base, "/api/debug/profile?seconds=0.2", "POST")
            assert (status, b) == (200, {"status": "captured", "seconds": 0.2,
                                         "logdir": str(logdir)})
        else:
            assert call(base, "/v1/profile/start", "POST")[::2] == (
                200, {"status": "tracing", "logdir": str(logdir)})
            assert call(base, "/v1/profile/start", "POST")[0] == 409
            assert call(base, "/v1/profile/stop", "POST")[::2] == (200, {"status": "stopped"})
            assert call(base, "/v1/profile/stop", "POST")[0] == 409
        assert any(p.is_file() for p in logdir.rglob("*"))
    assert list((tmp_path / "port").glob("trace-*.json"))


def test_memory_route_raises_without_a_card(stacks, tmp_path, monkeypatch):
    """The port's snapshot is the CUDA caching allocator's: a CPU process
    answers 500 where JAX writes a pprof of host buffers."""
    _, _, _, pbase = stacks
    monkeypatch.setenv("OPSAGENT_PROFILE_DIR", str(tmp_path))
    status, _, b = call(pbase, "/api/debug/memory")
    assert status == 500 and "no CUDA device" in b["error"]["message"]


def test_healthz_counts_queued_and_running(stacks):
    _, stack, _, pbase = stacks
    h = call(pbase, "/healthz")[2]
    assert h["running"] == 0 and h["prefilling"] == 0 and h["queued"] == 0
    assert h["free_pages"] == stack.engine.alloc.free_pages
    assert h["model"] == "tiny-test" and h["status"] == "ok"


def test_a_capture_during_traffic_holds_the_engine_ticks(stacks, tmp_path, monkeypatch):
    """The serving loop hosts the capture: the trace holds the scheduler
    thread's ``engine.*`` annotations, not only the handler's."""
    _, _, _, pbase = stacks
    monkeypatch.setenv("OPSAGENT_PROFILE_DIR", str(tmp_path))
    out = {}
    capture = threading.Thread(target=lambda: out.update(
        r=call(pbase, "/api/debug/profile?seconds=1.5", "POST")))
    capture.start()
    time.sleep(0.3)
    assert call(pbase, "/v1/chat/completions", "POST", body("watch the pods", 40))[0] == 200
    capture.join(timeout=60)
    assert out["r"][0] == 200
    (trace,) = tmp_path.glob("trace-*.json")
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    # The prompt is admitted through async mixed ticks (the default depth 2).
    assert {"engine.mixed_step_async", "engine.decode_block"} <= names


def test_scrapes_during_traffic_see_a_consistent_engine(stacks):
    """HTTP threads read the engine's gauges under its lock while the
    scheduler thread steps it: many scrapers, a short switch interval, and
    every scrape and request answers; the page pool is whole afterwards."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    _, stack, _, pbase = stacks
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    stop = threading.Event()

    def scrape():
        n = 0
        while not stop.is_set():
            for path in ("/metrics", "/healthz"):
                assert call(pbase, path)[0] == 200
                n += 1
        return n

    try:
        with ThreadPoolExecutor(12) as ex:
            scrapers = [ex.submit(scrape) for _ in range(8)]
            replies = list(ex.map(lambda i: call(pbase, "/v1/chat/completions", "POST",
                                                 body(f"node {i} " * 6, 12)), range(4)))
            stop.set()
            scraped = [f.result(timeout=120) for f in scrapers]
    finally:
        stop.set()
        sys.setswitchinterval(old)
    assert all(r[0] == 200 for r in replies) and min(scraped) > 0
    assert pobs.ENGINE_REQUESTS.value(outcome="completed") == 4
    acct = stack.engine.alloc.accounting()
    assert acct["total"] == stack.engine.cfg.num_pages and acct["owned"] == 0
