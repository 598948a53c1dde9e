"""The port's elastic scale-out (``serving/fleet/autoscale.py``) against the
JAX package's on the CPU. Tolerance: decisions, snapshots, counters and
greedy replies are exact.

- The policy (the cases of ``tests/test_autoscale.py``): a registry role
  flip; one launch in flight at a time; ``max_replicas``; the cooldown; the
  snapshot's state; each through both packages' ``Autoscaler`` over one
  event script (sheds by class, request-ready flips, ticks), every tick's
  decision, the snapshots and the scale counters equal.
- The router's side: a shed 429 is noted once by the scaler, and the
  router's ``/healthz`` carries the ``autoscale`` block (the port's stdlib
  app and JAX's aiohttp app, the same block).
- Scale-out from a port snapshot through ``LocalStackLauncher``: a shed
  burst launches a standby restored from the snapshot, a tick promotes it,
  requests routed to it answer as the source replica does with no failed
  request, and idle ticks drain and retire it.
- ``SubprocessLauncher`` spawns ``python -m opsagent_tpu_torch
  serve-engine --restore-snapshot ... --replica-role standby`` on
  sequential ports, polls ``/healthz`` and stops its process; ``serve-router``
  takes the four ``--autoscale-*`` flags with the JAX command's defaults.
"""

import gc
import json
import subprocess
import sys

import pytest

from _torch_fleet_kit import (  # noqa: F401 - port_state is an autouse fixture
    PKGS, call, close, fleet, package, port_state, serve_router, text)


def autoscale(name):
    if name == "jax":
        from opsagent_tpu.serving.fleet import autoscale as mod
    else:
        from opsagent_tpu_torch.serving.fleet import autoscale as mod
    return mod


class FakeLauncher:
    """Policy-only launcher: registers a standby ``ReplicaInfo`` (local, no
    handle: never reaped, never polled) and is request-ready only when the
    script says so."""

    def __init__(self, pkg, router):
        self.pkg, self.router = pkg, router
        self.launched, self.stopped, self.ready = [], [], set()

    def launch(self, replica_id):
        self.launched.append(replica_id)
        self.router.registry.register(
            self.pkg.registry.ReplicaInfo(replica_id=replica_id, role="standby", local=True))

    def request_ready(self, replica_id):
        return replica_id in self.ready

    def stop(self, replica_id):
        self.stopped.append(replica_id)


def _policy_run(name, script, **kw):
    """``script`` through one package's Autoscaler over a one-replica router:
    [every tick's decision and snapshot], the launcher's calls, the scale
    counters and the routable replicas at the end."""
    pkg = package(name)
    router = pkg.router.FleetRouter()
    router.registry.register(pkg.registry.ReplicaInfo(replica_id="r0", role="decode",
                                                      local=True))
    launcher = FakeLauncher(pkg, router)
    kw.setdefault("cooldown_s", 0.0)
    scaler = autoscale(name).Autoscaler(router, launcher, **kw)
    trace = []
    for op, arg in script:
        if op == "shed":
            scaler.note_shed(arg)
        elif op == "ready":
            launcher.ready.add(arg)
        else:
            trace.append((scaler.tick(), scaler.snapshot()))
    events = {d: pkg.obs.FLEET_SCALE_EVENTS.value(direction=d) for d in ("up", "promote", "down")}
    decode = sorted(i.replica_id for i in router.registry.alive(role="decode"))
    return trace, (launcher.launched, launcher.stopped), events, decode


POLICY = {
    # (Autoscaler keywords, script)
    "one_launch_in_flight": ({}, [
        ("tick", None), ("shed", ""), ("shed", "batch"), ("tick", None), ("shed", "batch"),
        ("tick", None), ("ready", "scale-1"), ("shed", "interactive"), ("tick", None),
        ("tick", None), ("tick", None)]),
    "max_replicas": ({"max_replicas": 1}, [
        ("shed", ""), ("tick", None), ("ready", "scale-1"), ("shed", ""), ("tick", None),
        ("shed", "batch"), ("tick", None)]),
    "cooldown": ({"cooldown_s": 3600.0}, [
        ("shed", ""), ("tick", None), ("ready", "scale-1"), ("shed", ""), ("tick", None)]),
    "snapshot_state": ({"max_replicas": 3}, [
        ("shed", "batch"), ("shed", "batch"), ("shed", "interactive"), ("tick", None),
        ("shed", "background")]),
    "retire_idle": ({"scale_down_after": 2}, [
        ("shed", ""), ("tick", None), ("ready", "scale-1"), ("tick", None), ("tick", None),
        ("tick", None), ("tick", None)]),
}


@pytest.mark.parametrize("case", sorted(POLICY))
def test_policy_decisions_equal_jax(case):
    kw, script = POLICY[case]
    got = _policy_run("torch", script, **kw)
    want = _policy_run("jax", script, **kw)
    assert got == want
    trace, (launched, stopped), events, decode = got
    if case == "one_launch_in_flight":
        # No launch without pressure; one launch while the first warms; the
        # next only after the promotion.
        assert [t["launched"] for t, _ in trace[:4]] == [None, "scale-1", None, "scale-2"]
        assert trace[3][0]["promoted"] == ["scale-1"] and events["promote"] == 1
    if case == "max_replicas":
        assert launched == ["scale-1"] and trace[1][0]["launched"] is None
    if case == "cooldown":
        assert launched == ["scale-1"]
    if case == "snapshot_state":
        snap = trace[-1][1]
        assert snap["pending"] == ["scale-1"] and snap["active"] == []
        assert snap["launched_total"] == 1 and snap["max_replicas"] == 3
    if case == "retire_idle":
        assert stopped == ["scale-1"] and decode == ["r0"] and events["down"] == 1


@pytest.mark.parametrize("name", PKGS)
def test_set_role_moves_a_replica_between_pools(name):
    reg = package(name).registry.ReplicaRegistry()
    reg.register(package(name).registry.ReplicaInfo(replica_id="s", role="standby", local=True))
    assert [i.replica_id for i in reg.alive(role="decode")] == []
    assert reg.set_role("s", "decode")
    assert [i.replica_id for i in reg.alive(role="decode")] == ["s"]
    assert not reg.set_role("ghost", "decode")


CHAT = {"messages": [{"role": "user", "content": "hello"}], "max_tokens": 4, "temperature": 0}


def test_shed_is_noted_and_healthz_carries_the_block():
    """Watermark 0: a request is shed (429), noted once by the scaler with
    its class; both routers' ``/healthz`` carry the same ``autoscale``
    block."""
    blocks = {}
    for name in PKGS:
        pkg = package(name)
        router, stacks = fleet(pkg, n=1)
        scaler = autoscale(name).Autoscaler(router, FakeLauncher(pkg, router))
        router.autoscaler = scaler
        router.shed_queue_depth = 0
        url, stop = serve_router(pkg, router)
        try:
            # Interactive: the batch watermark is max(1, 0 // 2) = 1.
            status, headers, _ = call(url, "/v1/chat/completions",
                                      {**CHAT, "slo_class": "interactive"})
            assert status == 429 and "Retry-After" in headers
            assert sum(pkg.obs.FLEET_SHED.value(**{"class": c})
                       for c in pkg.obs.SLO_CLASSES) == 1
            _, _, health = call(url, "/healthz")
            blocks[name] = health["autoscale"]
        finally:
            stop()
            close(stacks)
    assert blocks["torch"] == blocks["jax"]
    assert blocks["torch"]["shed_pending"] == 1
    assert blocks["torch"]["shed_pending_by_class"] == {"interactive": 1}
    assert blocks["torch"]["max_replicas"] == 4 and blocks["torch"]["active"] == []


def test_scale_out_from_a_port_snapshot_with_no_failed_request(tmp_path):
    """The JAX package's acceptance gate on the port: a shed burst launches
    a standby restored from r0's snapshot, promoted on the next tick; every
    request succeeds, the forced one on the standby answers as r0 does;
    idle ticks retire it through the drain."""
    import os

    from opsagent_tpu_torch.serving.api import ServingStack
    from opsagent_tpu_torch.serving.engine import Engine

    pkg = package("torch")
    mod = autoscale("torch")
    router, stacks = fleet(pkg, n=1)
    snapdir = str(tmp_path / "snap")
    launched = []

    def factory():
        stack = ServingStack(Engine.from_snapshot(snapdir, device="cpu"))
        launched.append(stack)
        return stack

    try:
        stacks[0].engine.snapshot(snapdir)
        scaler = mod.Autoscaler(router, mod.LocalStackLauncher(router, factory),
                                cooldown_s=0.0, scale_down_after=2)
        router.autoscaler = scaler
        router.shed_queue_depth = 0
        with pytest.raises(pkg.router.OverloadError):
            router.complete(dict(CHAT))
        assert scaler.tick()["launched"] == "scale-1"
        assert scaler.tick()["promoted"] == ["scale-1"]
        assert {i.replica_id for i in router.registry.alive(role="decode")} == {"r0", "scale-1"}
        router.shed_queue_depth = None
        want = text(router.complete(dict(CHAT), force_replica="r0"))
        for _ in range(3):
            assert text(router.complete(dict(CHAT))) == want
        assert text(router.complete(dict(CHAT), force_replica="scale-1")) == want
        assert pkg.obs.FLEET_REQUESTS.value(outcome="error") == 0
        retired = []
        for _ in range(4):
            retired += scaler.tick()["retired"]
        assert retired == ["scale-1"]
        assert {i.replica_id for i in router.registry.alive(role="decode")} == {"r0"}
        assert len(launched) == 1
        assert launched[0].engine.init_stats["restore_source"] == os.path.abspath(snapdir)
        assert pkg.obs.FLEET_SCALE_EVENTS.value(direction="down") == 1
    finally:
        close(stacks)
        gc.collect()


class FakeProc:
    def __init__(self, cmd, **kw):
        self.cmd, self.kw = cmd, kw
        self.pid, self.returncode, self.signals = 4242, None, []

    def poll(self):
        return self.returncode

    def terminate(self):
        self.signals.append("TERM")
        self.returncode = -15

    def wait(self, timeout=None):
        return self.returncode


def test_subprocess_launcher_spawns_the_ports_serve_engine(monkeypatch):
    mod = autoscale("torch")
    procs = []

    def popen(cmd, **kw):
        procs.append(FakeProc(cmd, **kw))
        return procs[-1]

    monkeypatch.setattr(mod.subprocess, "Popen", popen)
    launcher = mod.SubprocessLauncher("/snaps/a", "http://127.0.0.1:8090", port_base=9400,
                                      stdout=subprocess.DEVNULL)
    launcher.launch("scale-1")
    launcher.launch("scale-2")
    assert procs[0].cmd == [
        sys.executable, "-m", "opsagent_tpu_torch", "serve-engine",
        "--restore-snapshot", "/snaps/a", "--host", "127.0.0.1", "--port", "9400",
        "--join-fleet", "http://127.0.0.1:8090", "--advertise", "http://127.0.0.1:9400",
        "--replica-id", "scale-1", "--replica-role", "standby"]
    assert procs[1].cmd[procs[1].cmd.index("--port") + 1] == "9401"
    assert procs[0].kw == {"stdout": subprocess.DEVNULL}
    # The JAX launcher's command, the package aside.
    jcmd = None

    def jpopen(cmd, **kw):
        nonlocal jcmd
        jcmd = cmd
        return FakeProc(cmd)

    jmod = autoscale("jax")
    monkeypatch.setattr(jmod.subprocess, "Popen", jpopen)
    jmod.SubprocessLauncher("/snaps/a", "http://127.0.0.1:8090", port_base=9400).launch("scale-1")
    assert jcmd[:3] == [sys.executable, "-m", "opsagent_tpu.cli.main"]
    assert jcmd[3:] == procs[0].cmd[3:]
    # Nothing answers /healthz on these ports: not request-ready.
    assert launcher.url_of("scale-1") == "http://127.0.0.1:9400"
    monkeypatch.setattr(mod.urllib.request, "urlopen",
                        lambda *a, **k: (_ for _ in ()).throw(OSError("refused")))
    assert not launcher.request_ready("scale-1")
    launcher.stop("scale-1")
    assert procs[0].signals == ["TERM"] and not launcher.request_ready("scale-1")
    launcher.stop("scale-1")          # a second stop is a no-op
    assert procs[0].signals == ["TERM"]


def test_serve_router_takes_the_autoscale_flags(monkeypatch):
    from opsagent_tpu.cli.main import build_parser as jax_parser
    from opsagent_tpu_torch import __main__ as cli
    from opsagent_tpu_torch.serving.fleet import router as prouter

    seen = []
    monkeypatch.setattr(prouter, "run_router_server", lambda **kw: seen.append(kw))
    assert cli.main(["serve-router", "--port", "0"]) == 0
    jargs = jax_parser().parse_args(["serve-router"])
    assert {k: v for k, v in seen[0].items() if k.startswith("autoscale")} == {
        "autoscale_snapshot": jargs.autoscale_snapshot,
        "autoscale_max_replicas": jargs.autoscale_max_replicas,
        "autoscale_port_base": jargs.autoscale_port_base,
        "autoscale_cooldown_s": jargs.autoscale_cooldown,
    }
    assert cli.main(["serve-router", "--autoscale-snapshot", "/s", "--autoscale-max-replicas",
                     "2", "--autoscale-port-base", "9500", "--autoscale-cooldown", "5"]) == 0
    assert {k: v for k, v in seen[1].items() if k.startswith("autoscale")} == {
        "autoscale_snapshot": "/s", "autoscale_max_replicas": 2,
        "autoscale_port_base": 9500, "autoscale_cooldown_s": 5.0}


def test_router_server_starts_and_stops_the_scaler(monkeypatch):
    """``run_router_server`` with a snapshot wires a ``SubprocessLauncher``
    at the router's own URL into an ``Autoscaler``, starts it, and stops it
    with the server."""
    from opsagent_tpu_torch.serving.fleet import router as prouter

    mod = autoscale("torch")
    made = {}

    class Scaler(mod.Autoscaler):
        def __init__(self, router, launcher, **kw):
            super().__init__(router, launcher, **kw)
            made.update(scaler=self, launcher=launcher, kw=kw, router=router)

        def start(self):
            made["started"] = True

        def stop(self):
            made["stopped"] = True

    monkeypatch.setattr(mod, "Autoscaler", Scaler)

    def serve_forever(self):
        made["autoscaler_set"] = made["router"].autoscaler is made["scaler"]
        raise KeyboardInterrupt

    monkeypatch.setattr(prouter.ThreadingHTTPServer, "serve_forever", serve_forever)
    prouter.run_router_server(host="127.0.0.1", port=0, autoscale_snapshot="/snap",
                              autoscale_max_replicas=3, autoscale_cooldown_s=7.0)
    assert made["started"] and made["stopped"] and made["autoscaler_set"]
    assert made["kw"] == {"max_replicas": 3, "cooldown_s": 7.0}
    assert made["launcher"].snapshot_path == "/snap"
    assert made["launcher"].router_url.startswith("http://127.0.0.1:")
    assert json.dumps(made["scaler"].snapshot())
