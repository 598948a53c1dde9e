"""The port's fleet (``opsagent_tpu_torch/serving/fleet``) against the JAX
package's on the CPU. Tolerance: chain keys, snapshots, route decisions,
flight events and greedy tokens are exact; no logit is compared.

- Registry: one script of register, heartbeat (with the clock-sync echo),
  reap, ``note_result``, half-open probe, drain and role under a fake clock
  gives equal ``snapshot()`` and ``health_snapshot()`` after every step;
  ``prompt_chain_keys`` is equal over random token lists and page sizes.
- Placement: both routers over the same duck-typed replica handles make the
  same decisions over one request script (least-loaded, affinity, sticky,
  spill, forced, the prefill lane, hedge and shed).
- Two-replica fleets of each package and a single replica, tiny-test f32
  with the same weights (the JAX package's acceptance gates in
  ``tests/test_fleet.py``): a second turn routes by affinity and its owner
  restores; a forced mis-route ships the pages and its greedy text equals
  the single replica's; a drain of running sessions has no error and its
  tokens equal the never-drained run's.
"""

import random
import time

import pytest

from _torch_fleet_kit import (  # noqa: F401 - port_state is an autouse fixture
    PKGS, close, events, fleet, package, port_state, slow_decode, stack, text)


class FakeClock:
    def __init__(self):
        self.mono = 1000.0
        self.wall = 1.7e9

    def monotonic(self):
        return self.mono

    def time(self):
        return self.wall

    def perf_counter(self):
        return self.mono

    def sleep(self, s):
        self.mono += s


@pytest.fixture
def clocks(monkeypatch):
    """One fake clock behind both packages' registry and page directory."""
    clock = FakeClock()
    for name in PKGS:
        pkg = package(name)
        monkeypatch.setattr(pkg.registry, "time", clock)
        monkeypatch.setattr(pkg.pagestore, "time", clock)
    return clock


# -- registry ---------------------------------------------------------------------
def _registry_script(pkg, clock) -> list:
    R = pkg.registry
    reg = R.ReplicaRegistry(ttl_s=10.0, eject_cooldown=2.0)
    out = []

    def snap(tag):
        s = reg.snapshot()
        out.append((tag, s, reg.health_snapshot(), reg.health_snapshot(clock=True),
                    sorted(i.replica_id for i in reg.alive()),
                    sorted(i.replica_id for i in reg.alive(role="prefill")),
                    sorted(i.replica_id for i in reg.alive(admitting=False)),
                    reg.clock_offsets(), reg.directory.stats()))

    reg.register(R.ReplicaInfo(replica_id="a", url="http://a", capacity=4, page_size=8,
                               mesh={"tp": 1}, digests={"k1", "k2"},
                               load={"running": 1, "queued": 2}))
    reg.register(R.ReplicaInfo(replica_id="b", local=True, digests={"k1"}))
    reg.register(R.ReplicaInfo(replica_id="c", url="http://c", role="prefill"))
    snap("registered")
    clock.mono += 1.0
    clock.wall += 1.0
    out.append(reg.heartbeat("a", load={"running": 3, "queued": 0, "prefilling": 1},
                             digests=["k1", "k3"], digest_truncated=True,
                             replica_ts=clock.wall + 0.25, echo_router_ts=clock.wall - 0.1,
                             echo_held_s=0.04))
    out.append(reg.heartbeat("ghost"))
    snap("heartbeat")
    clock.mono += 6.0   # past ttl/2 for a and c: suspect
    out.append(reg.heartbeat("c", load={"queued": 5}))
    snap("half-ttl")
    for ok in (False, False, False):
        reg.note_result("a", ok)
        snap(f"result {ok}")
    clock.mono += 3.0   # a's cooldown (2 s) passed: half-open
    out.append(reg.heartbeat("a"))
    snap("cooldown passed")
    reg.begin_probe("a")
    snap("probe")
    reg.note_result("a", False)   # the probe fails: re-ejected, 4 s
    snap("probe failed")
    clock.mono += 5.0
    out.append(reg.heartbeat("a"))
    reg.note_result("a", True)
    snap("healthy again")
    out.append(reg.set_draining("b"))
    out.append(reg.set_draining("ghost"))
    snap("drain b")
    out.append(reg.set_role("c", "standby"))
    snap("role c")
    out.append(reg.set_draining("b", False))
    clock.mono += 11.0  # c's heartbeat is stale past the ttl: reaped
    out.append(reg.heartbeat("a"))
    out.append(reg.reap())
    snap("reaped")
    out.append(reg.deregister("a"))
    out.append(reg.deregister("a"))
    snap("deregistered")
    return out


def test_registry_script_equals_jax(clocks):
    got = {}
    for name in PKGS:
        clocks.mono, clocks.wall = 1000.0, 1.7e9
        got[name] = _registry_script(package(name), clocks)
    assert got["torch"] == got["jax"]
    # The walk the script drives: suspect, ejected, half-open, reaped.
    states = [step[2].get("a") for step in got["torch"] if isinstance(step, tuple)]
    assert {"suspect", "ejected", "healthy"} <= set(states)


def test_registry_metrics_equal_jax(clocks):
    for name in PKGS:
        _registry_script(package(name), clocks)
    vals = {name: {k: v for k, v in package(name).obs.metrics_snapshot().items()
                   if k.startswith(("opsagent_fleet_replica", "opsagent_fleet_ejections",
                                    "opsagent_fleet_clock"))}
            for name in PKGS}
    assert vals["torch"] == vals["jax"] and vals["torch"]


@pytest.mark.parametrize("page_size", [1, 4, 16, 64])
def test_prompt_chain_keys_equal_jax(page_size):
    rng = random.Random(page_size)
    jr, pr = package("jax").registry, package("torch").registry
    for n in (0, 1, 2, page_size, page_size + 1, 3 * page_size + 2, 300):
        toks = [rng.randrange(0, 128256) for _ in range(n)]
        assert pr.prompt_chain_keys(toks, page_size) == jr.prompt_chain_keys(toks, page_size)


# -- placement ----------------------------------------------------------------------
class FakeHandle:
    """A duck-typed replica handle: canned replies, every call recorded."""

    def __init__(self, rid, calls, pages=None):
        self.replica_id = rid
        self.calls = calls
        self.pages = pages or []

    def chat_completion(self, body):
        hop = body.get("fleet_hop") or {}
        self.calls.append(("chat", self.replica_id, body.get("max_tokens"), hop.get("hop")))
        return {"id": hop.get("request_id") or f"cmpl-{self.replica_id}",
                "choices": [{"index": 0, "message": {"role": "assistant",
                                                     "content": self.replica_id}}]}

    def export_pages(self, token_ids, park=True, start_page=0):
        self.calls.append(("export", self.replica_id, len(token_ids), park))
        return self.pages

    def import_pages(self, records):
        self.calls.append(("import", self.replica_id, len(records)))
        return len(records)


def _placement_script(pkg) -> list:
    R, F = pkg.registry, pkg.router
    calls: list = []
    reg = R.ReplicaRegistry(ttl_s=3600.0)
    router = F.FleetRouter(registry=reg, prefill_threshold=16, pagestore=False,
                           hedge_queue_depth=3, shed_queue_depth=4,
                           tokenizer=pkg.tokenizer.load_tokenizer(""))
    P = 4
    long_prompt = list(range(300, 340))
    keys = R.prompt_chain_keys(long_prompt, P)
    rec = [{"tokens": [1, 2, 3, 4], "leaves": []}]
    for rid, role, load in (("d0", "decode", {"running": 1}), ("d1", "decode", {"running": 0}),
                            ("d2", "decode", {"running": 2, "queued": 1}),
                            ("p0", "prefill", {})):
        reg.register(R.ReplicaInfo(replica_id=rid, url=f"http://{rid}", role=role,
                                   capacity=4, page_size=P, load=load,
                                   handle=FakeHandle(rid, calls, rec)))
    out = []

    def decide(tag, body, toks=None, force=None):
        d = router.route(body, toks, force_replica=force)
        out.append((tag, d.replica.replica_id, d.policy, d.affinity_pages, d.queue_depth,
                    d.migrate_from))
        return d

    body = {"messages": [{"role": "user", "content": "one"}], "session_id": "s1"}
    decide("cold", body, [1, 2, 3])
    reg.get("d2").digests = set(keys[:5])
    decide("affinity", {"messages": [{"role": "user", "content": "two"}]}, long_prompt)
    d = decide("least", body, long_prompt[:3])
    router._note_ownership(d, "cmpl-x")
    decide("pinned", body, long_prompt)
    reg.get(d.replica.replica_id).load = {"queued": 9}
    decide("spill", body, long_prompt)
    decide("forced", body, long_prompt, force="d0")
    # The whole request plane over the fake handles: a cold long prompt
    # takes the prefill lane and its pages flow to the decode replica.
    router._pins.clear()
    for rid in ("d0", "d1", "d2"):
        reg.get(rid).load = {}
    reg.get("d2").digests = set()
    calls.clear()
    resp = router.complete({"messages": [{"role": "user", "content": "x" * 40}],
                            "max_tokens": 5}, force_replica=None)
    out.append(("prefill lane", resp["fleet"], list(calls)))
    # Hedge: the chosen replica's queue is deep, the prompt is cold.
    for rid, q in (("d0", 3), ("d1", 5), ("d2", 6)):
        reg.get(rid).load = {"queued": q}
    hd = router.route({"messages": [{"role": "user", "content": "h"}]}, [7, 8])
    backup = router._pick_hedge_backup(hd)
    out.append(("hedge", hd.replica.replica_id, backup and backup.replica_id))
    # Shed: every decode queue at or past the watermark.
    for rid in ("d0", "d1", "d2"):
        reg.get(rid).load = {"queued": 4}
    with pytest.raises(F.OverloadError) as ei:
        router.complete({"messages": [{"role": "user", "content": "s"}], "max_tokens": 2})
    out.append(("shed", ei.value.status, ei.value.retry_after_s, str(ei.value)))
    # Batch work sheds at half the watermark: queues of 2 shed it only.
    for rid in ("d0", "d1", "d2"):
        reg.get(rid).load = {"queued": 2}
    d = router.route({"messages": [{"role": "user", "content": "i"}]}, None)
    out.append(("interactive admitted", d.replica.replica_id))
    with pytest.raises(F.OverloadError) as ei:
        router.complete({"messages": [{"role": "user", "content": "b"}], "max_tokens": 2,
                         "slo_class": "batch"})
    out.append(("shed batch", ei.value.retry_after_s, str(ei.value)))
    out.append(events(pkg, ("route_decision", "session_migrate", "request_shed",
                            "fleet_hedge")))
    return out


def test_placement_decisions_equal_jax():
    got = {name: _placement_script(package(name)) for name in PKGS}
    assert got["torch"] == got["jax"]
    policies = [step[2] for step in got["torch"] if isinstance(step, tuple) and len(step) == 6]
    assert policies == ["least_loaded", "affinity", "least_loaded", "pinned", "spill", "forced"]


# -- two-replica fleets (the JAX package's acceptance gates) ----------------------------
def _affinity_gate(pkg) -> dict:
    router, stacks = fleet(pkg)
    try:
        messages = [{"role": "system", "content": "fleet affinity test"},
                    {"role": "user", "content": "turn one of this session"}]
        r1 = router.complete({"messages": messages, "max_tokens": 8, "temperature": 0})
        owner_id = r1["fleet"]["replica"]
        owner = router.registry.get(owner_id).handle
        other = next(i.handle for i in router.registry.all() if i.replica_id != owner_id)
        messages.append({"role": "assistant", "content": text(r1)})
        parked = owner.park_tokens(owner.tokenize({"messages": messages}))
        router._pins.clear()   # only the digests can route the next turn home
        messages.append({"role": "user", "content": "and turn two"})
        own0 = owner.stack.engine.offload.restored_tokens
        oth0 = other.stack.engine.offload.restored_tokens
        r2 = router.complete({"messages": messages, "max_tokens": 6, "temperature": 0})
        return {
            "turns": [text(r1), text(r2)], "fleet": [r1["fleet"], r2["fleet"]],
            "parked": parked, "owner_restored": owner.stack.engine.offload.restored_tokens - own0,
            "other_restored": other.stack.engine.offload.restored_tokens - oth0,
            "decisions": events(pkg, ("route_decision",)),
        }
    finally:
        close(stacks)


def test_second_turn_routes_by_affinity_and_owner_restores():
    got = {name: _affinity_gate(package(name)) for name in PKGS}
    assert got["torch"] == got["jax"]
    g = got["torch"]
    assert g["fleet"][1] == {"replica": g["fleet"][0]["replica"], "policy": "affinity"}
    assert g["parked"] > 0 and g["owner_restored"] > 0 and g["other_restored"] == 0


def _single_turns(pkg, turns) -> list[str]:
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


def _misroute_gate(pkg) -> dict:
    router, stacks = fleet(pkg, pagestore=False)
    try:
        messages = [{"role": "user", "content": "first turn here"}]
        r1 = router.complete({"messages": messages, "max_tokens": 8, "temperature": 0})
        owner_id = r1["fleet"]["replica"]
        owner = router.registry.get(owner_id).handle
        target_id = next(i.replica_id for i in router.registry.all() if i.replica_id != owner_id)
        target = router.registry.get(target_id).handle
        messages += [{"role": "assistant", "content": text(r1)},
                     {"role": "user", "content": "second turn now"}]
        owner.park_tokens(owner.tokenize({"messages": messages}))
        t0 = pkg.obs.FLEET_TRANSFER_PAGES.value()
        tgt0 = target.stack.engine.offload.restored_tokens
        r2 = router.complete({"messages": messages, "max_tokens": 8, "temperature": 0},
                             force_replica=target_id)
        return {
            "turns": [text(r1), text(r2)], "replica": r2["fleet"],
            "pages": pkg.obs.FLEET_TRANSFER_PAGES.value() - t0,
            "restored": target.stack.engine.offload.restored_tokens - tgt0,
            "migrations": events(pkg, ("session_migrate",)),
        }
    finally:
        close(stacks)


def test_forced_misroute_transfers_pages_and_matches_single_replica():
    got = {name: _misroute_gate(package(name)) for name in PKGS}
    want = _single_turns(package("torch"), ["first turn here", "second turn now"])
    assert want == _single_turns(package("jax"), ["first turn here", "second turn now"])
    assert got["torch"] == got["jax"]
    g = got["torch"]
    assert g["turns"] == want
    assert g["pages"] > 0 and g["restored"] > 0
    assert [m["phase"] for m in g["migrations"]] == ["enter", "exit"]
    assert g["migrations"][0]["reason"] == "misroute" and g["migrations"][1]["pages"] > 0


PROMPTS = ([257, 3, 1, 4, 1, 5, 9, 2, 6], [257, 8, 6, 7, 5, 3, 0, 9, 11, 12, 40])
BUDGET = 40


def _drain_gate(pkg, offload=True) -> dict:
    router, stacks = fleet(pkg, engine_over={"offload": offload})
    slow_decode(stacks)
    try:
        S = pkg.SamplingParams
        reqs = [pkg.scheduler.Request(list(p), S(max_tokens=BUDGET)) for p in PROMPTS]
        streamed = [[] for _ in reqs]
        for r, sink in zip(reqs, streamed):
            r.on_token = sink.append
            stacks[0].scheduler.submit(r)
        deadline = time.time() + 60
        while time.time() < deadline and min(len(s) for s in streamed) < 6:
            time.sleep(0.002)
        b0 = stacks[1].engine.offload.restored_tokens if offload else 0
        out = router.drain("r0")
        for r in reqs:
            assert r.done.wait(120), "a request was lost by the drain"
        return {
            "drain": out, "errors": [r.error for r in reqs], "tokens": [r.tokens for r in reqs],
            "streamed": streamed, "salvaged": [len(r.generated_prefix) > 0 for r in reqs],
            "restored": (stacks[1].engine.offload.restored_tokens - b0) if offload else 0,
            "left": router.registry.get("r0") is None,
            "drains": events(pkg, ("replica_drain",)),
        }
    finally:
        close(stacks)


def _never_drained(pkg) -> list[list[int]]:
    eng = pkg.engine(offload=False)
    return [eng.generate([list(p)], pkg.SamplingParams(max_tokens=BUDGET))[0] for p in PROMPTS]


@pytest.mark.parametrize("offload", [True, False], ids=["host_tier", "no_host_tier"])
def test_graceful_drain_migrates_running_sessions_without_token_loss(offload):
    want = _never_drained(package("torch"))
    assert want == _never_drained(package("jax"))
    for name in PKGS:
        g = _drain_gate(package(name), offload)
        assert g["drain"] == {"replica": "r0", "migrated_sessions": 2, "errors": 0}, name
        assert g["errors"] == ["", ""] and g["tokens"] == want, name
        # Each token reached its stream once: no repeat, no loss at the seam.
        assert g["streamed"] == want, name
        assert all(g["salvaged"]) and g["left"], name
        if offload:
            assert g["restored"] > 0, name
        assert [(d["phase"], d.get("migrated"), d.get("errors")) for d in g["drains"]] == \
            [("enter", None, None), ("exit", 2, 0)], name


def test_forced_route_bypasses_the_shed_as_jax_does():
    """The reference's red test (``test_fleet_chaos.py::TestOverload::
    test_forced_route_bypasses_the_shed``) fails on its own model, not on
    the shed: the forced route is admitted, and tiny-test's random weights
    greedily answer "operator" with tokens the byte tokenizer renders as no
    text. The port holds the same: admitted, the same reply."""
    got = {}
    for name in PKGS:
        pkg = package(name)
        router, stacks = fleet(pkg, shed_queue_depth=0)
        try:
            body = {"messages": [{"role": "user", "content": "operator"}], "max_tokens": 4,
                    "temperature": 0}
            with pytest.raises(pkg.router.OverloadError):
                router.complete(dict(body))
            resp = router.complete(dict(body), force_replica="r0")
            got[name] = (text(resp), resp["choices"][0]["finish_reason"],
                         resp["usage"]["completion_tokens"], resp["fleet"])
        finally:
            close(stacks)
    assert got["torch"] == got["jax"]
    assert got["torch"][2] > 0 and got["torch"][3] == {"replica": "r0", "policy": "forced"}
