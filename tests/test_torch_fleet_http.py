"""The port's fleet over HTTP against the JAX package's, on the CPU.
Tolerance: statuses, JSON keys, headers named here, rendered text and
greedy tokens are exact; no logit is compared.

- The router's stdlib app (``build_router_app``) against JAX's aiohttp app,
  each over a two-replica in-process fleet of its own package: every route
  with the same status and JSON keys (completions plain and SSE, 400s,
  ``/v1/models``, ``/healthz``, ``/metrics``, ``/api/slo``,
  ``/api/metrics/history``, ``/api/fleet``, ``/api/fleet/bench``,
  ``/api/fleet/directory``, ``/api/fleet/flight``, ``/api/timeline/{id}``,
  ``/fleet/register``, ``/fleet/heartbeat`` with its 410,
  ``/fleet/directory/lookup``, ``/fleet/deregister``, ``/fleet/drain/{id}``
  with its 404) and 429 with Retry-After when every queue is past the shed
  watermark.
- A replica joining over HTTP (``FleetMembership``): it registers with the
  router, heartbeats its load and digests, takes ``/fleet/promote`` and
  ``/fleet/drain``, and shows it under ``/healthz`` ``fleet``; the same
  as JAX's.
- Across packages: the port's router over a JAX replica (JAX's
  ``build_engine_app`` on aiohttp) and a port replica: a session whose
  first turn ran on the JAX replica is forced onto the port's, its pages
  ship over ``/fleet/kv/export`` and ``/fleet/kv/import``, the port
  restores them, and its greedy text equals both packages' single-replica
  runs.
"""

import time

from _torch_fleet_kit import (  # noqa: F401 - port_state is an autouse fixture
    PKGS, call, close, fleet, package, port_state, serve_engine, serve_router, shape,
    sse_chunks, stack, text)

CHAT = {"messages": [{"role": "user", "content": "steady stream"}], "max_tokens": 8,
        "temperature": 0}


def unbreached(v):
    """``v`` without ``breached_for_s``, which an SLO verdict carries only
    while it breaches (CPU latencies differ between the packages)."""
    if isinstance(v, dict):
        return {k: unbreached(x) for k, x in v.items() if k != "breached_for_s"}
    if isinstance(v, list):
        return [unbreached(x) for x in v]
    return v


def _router_surface(pkg) -> list:
    router, stacks = fleet(pkg)
    url, stop = serve_router(pkg, router)
    out = []

    def rec(tag, status, payload, keys=True):
        out.append((tag, status, shape(unbreached(payload)) if keys else payload))
        return payload

    try:
        s, _, body = call(url, "/v1/chat/completions", CHAT)
        # The port's engine reply carries its TTFT (``ttft_s``, read by the
        # card's serve phases); the router passes replies through.
        rec("chat", s, {k: v for k, v in body.items() if k != "ttft_s"})
        out.append(("chat text", text(body), body["fleet"]))
        rid = body["id"]
        s, _, sse = call(url, "/v1/chat/completions", dict(CHAT, stream=True))
        chunks = sse_chunks(sse)
        shapes = [shape(c) if isinstance(c, dict) else c for c in chunks]
        # The chunks' keys: the head, the content deltas (how many the
        # engine emits is its own), the finish and [DONE].
        out.append(("sse", s, shapes[0], shapes[-2:],
                    sorted({str(x) for x in shapes[1:-2]})))
        out.append(("sse text", "".join((c["choices"][0]["delta"].get("content") or "")
                                        for c in chunks if isinstance(c, dict))))
        rec("bad json", *call(url, "/v1/chat/completions", raw=b"{nope")[::2], keys=False)
        rec("no messages", *call(url, "/v1/chat/completions", {"max_tokens": 2})[::2],
            keys=False)
        rec("models", *call(url, "/v1/models")[::2], keys=False)
        rec("healthz", *call(url, "/healthz")[::2])
        s, headers, metrics = call(url, "/metrics")
        out.append(("metrics", s, headers["Content-Type"].split(";")[0],
                    "opsagent_fleet_route_decisions_total" in metrics))
        rec("slo", *call(url, "/api/slo")[::2])
        rec("history", *call(url, "/api/metrics/history?since=60")[::2])
        rec("history bad", *call(url, "/api/metrics/history?since=x")[::2], keys=False)
        rec("fleet", *call(url, "/api/fleet")[::2])
        rec("bench", *call(url, "/api/fleet/bench")[::2])
        rec("directory", *call(url, "/api/fleet/directory?limit=4")[::2])
        rec("flight", *call(url, "/api/fleet/flight?n=5&kind=route_decision")[::2])
        s, _, tl = call(url, f"/api/timeline/{rid}")
        out.append(("timeline", s, sorted(tl), tl["replica"] == body["fleet"]["replica"]))
        rec("timeline 404", *call(url, "/api/timeline/nope-123")[::2], keys=False)
        rec("register 400", *call(url, "/fleet/register", {"replica_id": "x"})[::2],
            keys=False)
        rec("register", *call(url, "/fleet/register", {
            "replica_id": "remote-1", "url": "http://127.0.0.1:1", "model": "tiny-test",
            "capacity": 2, "page_size": 4, "digests": ["aa", "bb"]})[::2])
        rec("heartbeat", *call(url, "/fleet/heartbeat", {
            "replica_id": "remote-1", "load": {"running": 1}, "digests": ["aa"]})[::2])
        rec("lookup", *call(url, "/fleet/directory/lookup", {"keys": ["aa", "zz"]})[::2],
            keys=False)
        rec("lookup 400", *call(url, "/fleet/directory/lookup", raw=b"[")[::2], keys=False)
        rec("deregister", *call(url, "/fleet/deregister", {"replica_id": "remote-1"})[::2],
            keys=False)
        rec("heartbeat 410", *call(url, "/fleet/heartbeat", {"replica_id": "remote-1"})[::2],
            keys=False)
        rec("drain", *call(url, "/fleet/drain/r1", {})[::2], keys=False)
        rec("drain 404", *call(url, "/fleet/drain/ghost", {})[::2], keys=False)
        router.shed_queue_depth = 0
        s, headers, shed = call(url, "/v1/chat/completions", CHAT)
        out.append(("shed", s, headers.get("Retry-After"), shed))
        s, headers, shed = call(url, "/v1/chat/completions", dict(CHAT, stream=True))
        out.append(("shed sse", s, headers.get("Retry-After"), shed))
    finally:
        stop()
        close(stacks)
    return out


def test_router_http_surface_equals_jax():
    got = {name: _router_surface(package(name)) for name in PKGS}
    for a, b in zip(got["torch"], got["jax"]):
        assert a == b, (a, b)
    assert len(got["torch"]) == len(got["jax"])
    tags = {row[0]: row for row in got["torch"]}
    assert tags["shed"][1] == 429 and tags["shed"][2] == "1"
    assert tags["drain"][2] == {"replica": "r1", "migrated_sessions": 0, "errors": 0}
    assert tags["heartbeat 410"][1] == 410 and tags["timeline"][1] == 200


def _joined_replica(pkg) -> dict:
    router = pkg.router.FleetRouter()
    rurl, rstop = serve_router(pkg, router)
    s = stack(pkg)
    m = pkg.client.FleetMembership(s, router_url=rurl, advertise_url="http://127.0.0.1:9",
                                   replica_id="joined", role="standby",
                                   heartbeat_interval_s=0.02)
    eurl, estop = serve_engine(pkg, s, membership=m)
    m.advertise_url = eurl
    try:
        m.start()
        s.chat_completion({"messages": [{"role": "user", "content": "fill the trie"}],
                           "max_tokens": 4, "temperature": 0})
        want = set(s.engine.prefix_digests())
        deadline = time.time() + 30
        while time.time() < deadline:
            info = router.registry.get("joined")
            if info.digests == want and info.load.get("running") == 0:
                break
            time.sleep(0.02)
        info = router.registry.get("joined")
        row = {k: v for k, v in info.snapshot().items() if k != "heartbeat_age_s"}
        _, _, before = call(eurl, "/healthz")
        promote = call(eurl, "/fleet/promote", {"role": "decode"})[::2]
        drain = call(eurl, "/fleet/drain", {})[::2]
        _, _, after = call(eurl, "/healthz")
        return {"row": row, "health": router.registry.health_snapshot(),
                "fleet_before": before["fleet"], "promote": promote, "drain": drain,
                "fleet_after": after["fleet"], "role": m.role,
                "ok": m.registered and m.last_heartbeat_ok}
    finally:
        m.stop()
        estop()
        rstop()
        s.close()


def test_joined_replica_registers_heartbeats_and_takes_promote():
    got = {name: _joined_replica(package(name)) for name in PKGS}
    for g in got.values():
        g["row"]["url"] = g["fleet_before"]["router_url"] = g["fleet_after"]["router_url"] = ""
    assert got["torch"] == got["jax"]
    g = got["torch"]
    assert g["ok"] and g["row"]["digest_count"] > 0 and g["row"]["role"] == "standby"
    assert g["role"] == "decode" and g["promote"] == (200, {"status": "ok", "role": "decode"})
    assert g["fleet_before"]["draining"] is False and g["fleet_after"]["draining"] is True


def _single(pkg, turns) -> list[str]:
    s = stack(pkg)
    try:
        out, messages = [], []
        for user in turns:
            messages.append({"role": "user", "content": user})
            out.append(text(s.chat_completion({"messages": list(messages), "max_tokens": 8,
                                               "temperature": 0})))
            messages.append({"role": "assistant", "content": out[-1]})
        return out
    finally:
        s.close()


def test_session_migrates_from_a_jax_replica_to_the_port_over_http():
    jpkg, ppkg = package("jax"), package("torch")
    turns = ["first turn across packages", "second turn on the port"]
    want = _single(ppkg, turns)
    assert want == _single(jpkg, turns)
    js, ps = stack(jpkg), stack(ppkg)
    jurl, jstop = serve_engine(jpkg, js)
    purl, pstop = serve_engine(ppkg, ps)
    router = ppkg.router.FleetRouter(pagestore=False,
                                     tokenizer=ppkg.tokenizer.load_tokenizer(""),
                                     model_family="tiny-test")
    R = ppkg.registry
    for rid, url in (("jax", jurl), ("port", purl)):
        router.registry.register(R.ReplicaInfo(
            replica_id=rid, url=url, model="tiny-test", capacity=4, page_size=4,
            handle=ppkg.router.HttpReplica(url, rid)))
    try:
        messages = [{"role": "user", "content": turns[0]}]
        r1 = router.complete({"messages": messages, "max_tokens": 8, "temperature": 0},
                             force_replica="jax")
        messages += [{"role": "assistant", "content": text(r1)},
                     {"role": "user", "content": turns[1]}]
        restored0 = ps.engine.offload.restored_tokens
        r2 = router.complete({"messages": messages, "max_tokens": 8, "temperature": 0},
                             force_replica="port")
        migrations = [e for e in ppkg.obs.flight.get_recorder().snapshot(kind="session_migrate")
                      if e["phase"] == "exit"]
        assert [text(r1), text(r2)] == want
        assert r2["fleet"] == {"replica": "port", "policy": "forced"}
        assert migrations and migrations[-1]["src"] == "jax" and migrations[-1]["pages"] > 0
        assert ps.engine.offload.restored_tokens - restored0 == 4 * migrations[-1]["pages"]
    finally:
        jstop()
        pstop()
        js.close()
        ps.close()
