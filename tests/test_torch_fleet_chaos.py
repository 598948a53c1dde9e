"""The fleet's fault points in the port against the JAX package's, on the
CPU: each point, under the same ``OPSAGENT_FAULTS`` spec over the same
workload in both packages, fires at the same hit, gives the same sequence
of ``fault_injected`` and outcome flight events (kinds, points, hits,
phases, reasons) and the same client-visible result, which equals the
undisturbed run's. Tolerance: exact (greedy text and tokens included).

Points: ``fleet.connect`` and ``fleet.timeout`` (an HTTP replica's call
fails, the router retries on the other), ``fleet.stream_disconnect`` (a
mid-SSE failover whose text is byte-identical), ``transfer.corrupt`` and
``transfer.truncate`` (a pushed page rejected, the receiver re-prefills),
``client.heartbeat_drop`` (one beat lost, the membership beats on),
``sched.step_fault`` (three faulted ticks force an engine restart),
``sched.out_of_pages`` (an admission storm retried to completion),
``pagestore.fetch_timeout`` and ``pagestore.stale_entry`` (a fault-in that
degrades to a re-prefill).
"""

import queue
import time
import urllib.error

import pytest

from _torch_fleet_kit import (  # noqa: F401 - port_state is an autouse fixture
    PKGS, close, events, fleet, package, port_state, serve_engine, stack, text)

OUTCOMES = ("fault_injected", "fleet_retry", "failover", "session_migrate", "anomaly",
            "page_fault_in", "engine_restart")


# Anomalies of the clock (the JAX engines compile on the CPU inside a TTFT).
CLOCKED = {"ttft_breach", "slo_breach", "post_warmup_compile"}


def _events(pkg) -> list[dict]:
    return [{k: v for k, v in e.items() if k not in ("error", "seq_id", "expected", "got",
                                                    "emitted_chars", "dump")}
            for e in events(pkg, OUTCOMES) if e.get("reason") not in CLOCKED]


def _both(fn) -> dict:
    return {name: fn(package(name)) for name in PKGS}


# -- router -------------------------------------------------------------------------
@pytest.mark.parametrize("point", ["fleet.connect", "fleet.timeout"])
def test_http_replica_call_fault_retries_on_the_other_replica(point):
    body = {"messages": [{"role": "user", "content": "steady stream"}], "max_tokens": 8,
            "temperature": 0}

    def run(pkg):
        stacks = [stack(pkg), stack(pkg)]
        servers = [serve_engine(pkg, s) for s in stacks]
        router = pkg.router.FleetRouter()
        for rid, (url, _) in zip(("a", "b"), servers):
            router.registry.register(pkg.registry.ReplicaInfo(
                replica_id=rid, url=url, model="tiny-test", capacity=4, page_size=4,
                handle=pkg.router.HttpReplica(url, rid)))
        try:
            undisturbed = router.complete(dict(body), force_replica="b")
            pkg.obs.flight.get_recorder().reset()
            pkg.faults.configure(f"{point}@1")
            resp = router.complete(dict(body))
            return {"text": text(resp), "want": text(undisturbed), "fleet": resp["fleet"],
                    "events": _events(pkg), "health": router.registry.health_snapshot(),
                    "fired": pkg.obs.FAULT_INJECTIONS.value(point=point)}
        finally:
            pkg.faults.reset()
            for _, stop in servers:
                stop()
            close(stacks)

    got = _both(run)
    assert got["torch"] == got["jax"]
    g = got["torch"]
    # The session is pinned to b by the undisturbed run: b's call fails and
    # the retry lands on a.
    assert g["text"] == g["want"] and g["fleet"] == {"replica": "a", "policy": "least_loaded"}
    assert g["fired"] == 1 and g["health"] == {"a": "healthy", "b": "suspect"}
    assert [(e["kind"], e.get("point"), e.get("hit")) for e in g["events"]] == \
        [("fault_injected", point, 1), ("fleet_retry", None, None)]


def test_stream_disconnect_fails_over_byte_identical():
    body = {"messages": [{"role": "user", "content": "steady stream"}], "max_tokens": 8,
            "temperature": 0, "stream": True}

    def run(pkg):
        router, stacks = fleet(pkg)
        try:
            def collect():
                chunks = list(router.complete_stream(dict(body)))
                heads = [c for c in chunks if "role" in c["choices"][0].get("delta", {})]
                finals = [c for c in chunks if c["choices"][0].get("finish_reason")]
                assert len(heads) == 1 and len(finals) == 1 and \
                    all("error" not in c for c in chunks)
                return "".join(c["choices"][0]["delta"].get("content") or "" for c in chunks)

            undisturbed = collect()
            pkg.obs.flight.get_recorder().reset()
            pkg.faults.configure("fleet.stream_disconnect@2")
            resumed = collect()
            return {"text": resumed, "want": undisturbed, "events": _events(pkg),
                    "failovers": pkg.obs.FLEET_FAILOVERS.value()}
        finally:
            pkg.faults.reset()
            close(stacks)

    got = _both(run)
    assert got["torch"] == got["jax"]
    g = got["torch"]
    assert g["text"] == g["want"] and g["text"] and g["failovers"] == 1
    # The failover ships the session's pages from the failed replica.
    assert [(e["kind"], e.get("point") or e.get("reason"), e.get("hit") or e.get("phase"))
            for e in g["events"]] == \
        [("fault_injected", "fleet.stream_disconnect", 2), ("failover", None, None),
         ("session_migrate", "failover", "enter"), ("session_migrate", "failover", "exit")]


# -- transfer -----------------------------------------------------------------------
@pytest.mark.parametrize("point", ["transfer.corrupt", "transfer.truncate"])
def test_pushed_page_fault_is_rejected_and_the_receiver_reprefills(point):
    def run(pkg):
        router, stacks = fleet(pkg, pagestore=False)
        try:
            messages = [{"role": "user", "content": "first turn here"}]
            r1 = router.complete({"messages": messages, "max_tokens": 8, "temperature": 0},
                                 force_replica="r0")
            messages += [{"role": "assistant", "content": text(r1)},
                         {"role": "user", "content": "second turn now"}]
            owner = router.registry.get("r0").handle
            owner.park_tokens(owner.tokenize({"messages": messages}))
            pkg.obs.flight.get_recorder().reset()
            pkg.faults.configure(f"{point}@1")
            r2 = router.complete({"messages": messages, "max_tokens": 8, "temperature": 0},
                                 force_replica="r1")
            return {"turns": [text(r1), text(r2)], "events": _events(pkg),
                    "rejects": pkg.obs.FLEET_KV_IMPORT_REJECTS.value()}
        finally:
            pkg.faults.reset()
            close(stacks)

    got = _both(run)
    assert got["torch"] == got["jax"]
    g = got["torch"]
    s = stack(package("torch"))
    try:
        messages = [{"role": "user", "content": "first turn here"}]
        want1 = text(s.chat_completion({"messages": messages, "max_tokens": 8, "temperature": 0}))
        messages += [{"role": "assistant", "content": want1},
                     {"role": "user", "content": "second turn now"}]
        want2 = text(s.chat_completion({"messages": messages, "max_tokens": 8, "temperature": 0}))
    finally:
        s.close()
    assert g["turns"] == [want1, want2] and g["rejects"] == 1
    kinds = [(e["kind"], e.get("point") or e.get("reason")) for e in g["events"]]
    assert ("fault_injected", point) in kinds and ("anomaly", "kv_import_reject") in kinds


# -- membership -----------------------------------------------------------------------
def test_heartbeat_drop_is_injected_and_the_membership_beats_on():
    def run(pkg):
        class Sched:
            _running: dict = {}
            _waiting: list = []
            _prefilling: dict = {}
            _queue = queue.Queue()

        class Alloc:
            free_pages = 7

        class Cfg:
            max_batch_size, page_size, tp, sp, ep = 4, 8, 1, 1, 1

        class Eng:
            alloc, cfg, offload = Alloc(), Cfg(), None

            def prefix_digests(self):
                return []

        class Stack:
            engine, scheduler, model_name = Eng(), Sched(), "tiny-test"

        m = pkg.client.FleetMembership(Stack(), "http://127.0.0.1:9", "http://127.0.0.1:8",
                                       replica_id="hb-test", heartbeat_interval_s=0.01)
        posts = []

        def post(path, body):
            posts.append(path)
            if path == "/fleet/heartbeat" and posts.count("/fleet/heartbeat") == 2:
                raise urllib.error.URLError("blip")
            return {"status": "ok"}

        m._post = post
        pkg.faults.configure("client.heartbeat_drop@2")
        m.start()
        try:
            deadline = time.time() + 10
            while time.time() < deadline and posts.count("/fleet/heartbeat") < 4:
                time.sleep(0.02)
        finally:
            m.stop(deregister=False)
            pkg.faults.reset()
        return {"first": posts[:4], "registered": m.registered,
                "fired": pkg.obs.FAULT_INJECTIONS.value(point="client.heartbeat_drop"),
                "events": _events(pkg), "block": m.healthz_block()}

    got = _both(run)
    for g in got.values():
        g["block"].pop("last_heartbeat_ok")
    assert got["torch"] == got["jax"]
    g = got["torch"]
    assert g["first"] == ["/fleet/register"] + ["/fleet/heartbeat"] * 3
    assert g["registered"] and g["fired"] == 1


# -- scheduler ------------------------------------------------------------------------
def test_step_faults_force_an_engine_restart_and_recover():
    def run(pkg):
        want = pkg.engine(offload=False).generate([[5, 6, 7]], pkg.SamplingParams(max_tokens=6))[0]
        sched = pkg.scheduler.Scheduler(pkg.engine(offload=False),
                                        engine_factory=lambda: pkg.engine(offload=False))
        pkg.faults.configure("sched.step_fault@1..3")
        sched.start()
        try:
            req = sched.submit(pkg.scheduler.Request([5, 6, 7], pkg.SamplingParams(max_tokens=6)))
            assert req.done.wait(120), "never recovered from step faults"
            return {"tokens": req.tokens, "want": want, "error": req.error,
                    "restarts": sched._restarts, "events": _events(pkg),
                    "fired": pkg.obs.FAULT_INJECTIONS.value(point="sched.step_fault")}
        finally:
            sched.stop()
            pkg.faults.reset()

    got = _both(run)
    assert got["torch"] == got["jax"]
    g = got["torch"]
    assert g["tokens"] == g["want"] and not g["error"] and g["restarts"] == 1 and g["fired"] == 3
    assert [(e["kind"], e.get("point") or e.get("reason")) for e in g["events"]] == \
        [("fault_injected", "sched.step_fault")] * 3 + [("anomaly", "engine_restart")]


def test_out_of_pages_storm_retries_to_completion():
    def run(pkg):
        want = pkg.engine(offload=False).generate([[1, 2, 3, 4]],
                                                  pkg.SamplingParams(max_tokens=4))[0]
        sched = pkg.scheduler.Scheduler(pkg.engine(offload=False))
        pkg.faults.configure("sched.out_of_pages@1..3")
        sched.start()
        try:
            req = sched.submit(pkg.scheduler.Request([1, 2, 3, 4],
                                                     pkg.SamplingParams(max_tokens=4)))
            assert req.done.wait(60), "storm never cleared"
            return {"tokens": req.tokens, "want": want, "error": req.error,
                    "events": _events(pkg),
                    "fired": pkg.obs.FAULT_INJECTIONS.value(point="sched.out_of_pages")}
        finally:
            sched.stop()
            pkg.faults.reset()

    got = _both(run)
    assert got["torch"] == got["jax"]
    g = got["torch"]
    assert g["tokens"] == g["want"] and not g["error"] and g["fired"] == 3
    assert [(e["kind"], e.get("point"), e.get("hit")) for e in g["events"]] == \
        [("fault_injected", "sched.out_of_pages", h) for h in (1, 2, 3)]


# -- page store -------------------------------------------------------------------------
@pytest.mark.parametrize("spec", ["pagestore.fetch_timeout@1+", "pagestore.stale_entry@1"])
def test_fault_in_fault_degrades_to_reprefill_with_no_client_error(spec):
    def run(pkg):
        router, stacks = fleet(pkg)
        try:
            messages = [{"role": "system", "content": "pagestore timeout test"},
                        {"role": "user", "content": "first turn here"}]
            r1 = router.complete({"messages": messages, "max_tokens": 8, "temperature": 0},
                                 force_replica="r0")
            messages += [{"role": "assistant", "content": text(r1)},
                         {"role": "user", "content": "second turn now"}]
            pkg.obs.flight.get_recorder().reset()
            pkg.faults.configure(spec)
            r2 = router.complete({"messages": messages, "max_tokens": 8, "temperature": 0},
                                 force_replica="r1")
            return {"turns": [text(r1), text(r2)], "events": _events(pkg),
                    "hits": pkg.obs.PAGESTORE_REMOTE_HITS.value(),
                    "stale": pkg.obs.PAGESTORE_STALE_ENTRIES.value(),
                    "restored": router.registry.get("r1").handle.stack.engine.offload
                    .restored_tokens}
        finally:
            pkg.faults.reset()
            close(stacks)

    got = _both(run)
    assert got["torch"] == got["jax"]
    g = got["torch"]
    s = stack(package("torch"))
    try:
        messages = [{"role": "system", "content": "pagestore timeout test"},
                    {"role": "user", "content": "first turn here"}]
        want1 = text(s.chat_completion({"messages": messages, "max_tokens": 8, "temperature": 0}))
        messages += [{"role": "assistant", "content": want1},
                     {"role": "user", "content": "second turn now"}]
        want2 = text(s.chat_completion({"messages": messages, "max_tokens": 8, "temperature": 0}))
    finally:
        s.close()
    assert g["turns"] == [want1, want2] and g["hits"] == 0 and g["restored"] == 0
    point = spec.split("@")[0]
    assert [(e["kind"], e.get("point")) for e in g["events"]][:2] == \
        [("page_fault_in", None), ("fault_injected", point)]
    assert g["events"][-1]["kind"] == "page_fault_in" and g["events"][-1]["outcome"] == "miss"
