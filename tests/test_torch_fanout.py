"""The port's audit fan-out (``agent/fanout``, ``cli/fanout.py``) against the
JAX package's on the CPU. Tolerance: bytes, counts and events are exact.

- ``SynthCluster`` and ``detect_findings``: inventory text, work items,
  ground truth, every resource's ``describe`` and its findings equal the
  JAX package's over several ``(resources, seed, issue_fraction)``.
- ``run_audit`` over fake routers (the JAX package's ``tests/test_fanout.py``
  cases): the canonical report byte-identical to JAX's and across runs,
  full recall, a failed child contained as a ``finding_unavailable`` row, a
  shed child retried, the plan and reduce flight events, the counters and
  the history series; the same through both packages.
- Over in-process fleets of two tiny-test replicas with the same weights
  (``params_from_jax``): the port's canonical report equals JAX's over
  JAX's router byte for byte, both primes land and every child avoids
  re-prefilling the shared prefix. The acceptance gates of
  ``tests/test_fanout.py::_acceptance`` on the port (every child ok, recall
  1.0, at least 90 % of the children avoided re-prefill, byte-identical
  reduce, no post-warmup compile, interactive probes beside the wave none
  shed), all but the wall-clock TTFT bound, which is load-sensitive on the
  CPU and which the card's ``fanout`` phase measures.
- ``python -m opsagent_tpu_torch audit-fanout --json``: the canonical
  report on stdout and exit 0; exit 1 with a child degraded.
"""

import json
import threading

import pytest

from _torch_fleet_kit import (  # noqa: F401 - port_state is an autouse fixture
    PKGS, close, fleet, package, port_state)


def fanout(name):
    """The package's ``agent.fanout`` (its ``synthcluster`` module an
    attribute)."""
    if name == "jax":
        from opsagent_tpu.agent import fanout as mod
    else:
        from opsagent_tpu_torch.agent import fanout as mod
    return mod


# -- the synthetic cluster --------------------------------------------------------
@pytest.mark.parametrize("resources,seed,fraction", [
    (1, 0, 0.25), (12, 3, 0.25), (40, 1, 0.25), (64, 7, 0.5), (33, 11, 0.0)])
def test_synth_cluster_and_findings_equal_jax(resources, seed, fraction):
    out = {}
    for name in PKGS:
        mod = fanout(name)
        c = mod.SynthCluster(resources=resources, seed=seed, issue_fraction=fraction)
        out[name] = (
            c.inventory_text(), c.work_items(), c.ground_truth(),
            [c.describe(r) for r in c.work_items()], c.describe("nowhere/ghost"),
            [mod.detect_findings(c.describe(r), r) for r in c.work_items()],
            [mod.synthcluster.severity_rank(s) for s in ("critical", "none", "bogus")],
        )
    assert out["torch"] == out["jax"]
    truth = out["torch"][2]
    assert len(truth) == min(resources, max(1, round(resources * fraction)))


# -- run_audit over fake routers ---------------------------------------------------
class _FakeInfo:
    page_size = 4

    def __init__(self, rid):
        self.replica_id = rid


class _FakeRegistry:
    def __init__(self, n):
        self._infos = [_FakeInfo(f"r{i}") for i in range(n)]

    def alive(self, role=None):
        return list(self._infos)


class _FakeRouter:
    """Tokenize = one token per character; ``complete`` succeeds unless the
    resource is in ``fail`` (always) or ``shed_once`` (its first call)."""

    def __init__(self, pkg, n=1, fail=(), shed_once=()):
        self.pkg = pkg
        self.registry = _FakeRegistry(n)
        self.fail, self.shed = set(fail), set(shed_once)
        self.lock = threading.Lock()

    def tokenize(self, body):
        return [ord(ch) for m in body["messages"] for ch in m["content"]]

    def complete(self, body, force_replica=None):
        if force_replica is not None:
            return {"choices": [{"message": {"content": "{}"}}]}
        user = body["messages"][1]["content"]
        for r in self.fail:
            if r in user:
                raise RuntimeError("child exploded")
        with self.lock:
            for r in tuple(self.shed):
                if r in user:
                    self.shed.discard(r)
                    raise self.pkg.router.OverloadError("fleet overloaded", 1)
        return {"choices": [{"message": {"content": "{}"}}]}


CASES = {
    # (resources, seed, replicas, index failing, index shed once, retries)
    "clean": (24, 5, 2, None, None, 2),
    "failed_child": (12, 2, 1, 3, None, 1),
    "shed_child_retried": (8, 4, 1, None, 0, 2),
    "shed_child_exhausted": (8, 4, 1, None, 0, 0),
}


def _audit(name, case):
    resources, seed, replicas, fail, shed, retries = CASES[case]
    pkg, mod = package(name), fanout(name)
    cluster = mod.SynthCluster(resources=resources, seed=seed)
    items = cluster.work_items()
    router = _FakeRouter(pkg, replicas, fail=() if fail is None else (items[fail],),
                         shed_once=() if shed is None else (items[shed],))
    rep = mod.run_audit(router, cluster, mod.FanoutConfig(
        max_inflight=4, retries=retries, retry_backoff_s=0.0))
    rec = pkg.obs.flight.get_recorder()
    plans = [{k: e[k] for k in ("children", "shared_prefix_tokens", "page_size")}
             for e in rec.snapshot(kind="fanout_plan") if e["fanout_id"] == rep.fanout_id]
    reduces = [{k: e[k] for k in ("children", "findings", "outcomes", "avoided_children")}
               for e in rec.snapshot(kind="fanout_reduce") if e["fanout_id"] == rep.fanout_id]
    counters = {
        "children": {o: pkg.obs.FANOUT_CHILDREN.value(outcome=o) for o in ("ok", "shed",
                                                                          "failed")},
        "findings": {s: pkg.obs.FANOUT_FINDINGS.value(severity=s)
                     for s in mod.synthcluster.SEVERITIES},
        "gauges": (pkg.obs.FANOUT_CHILDREN_TOTAL.value(), pkg.obs.FANOUT_CHILDREN_DONE.value(),
                   pkg.obs.FANOUT_ACTIVE.value()),
    }
    stats = {k: rep.stats[k] for k in ("children", "outcomes", "primes",
                                       "shared_prefix_tokens")}
    return rep, cluster, (rep.canonical, stats, plans, reduces, counters)


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_audit_over_fake_routers_equals_jax(case):
    got_rep, cluster, got = _audit("torch", case)
    _, _, want = _audit("jax", case)
    assert got == want
    rows = [f for f in got_rep.findings if f["issue"] == "finding_unavailable"]
    if case == "clean":
        assert got_rep.recall(cluster) == 1.0 and got_rep.stats["primes"] == 2
        _, _, again = _audit("torch", case)
        assert again[0] == got[0]               # byte-identical across runs
    if case == "failed_child":
        assert len(rows) == 1 and got_rep.report["summary"]["unavailable"] == 1
    if case == "shed_child_retried":
        assert not rows and got_rep.stats["outcomes"]["ok"] == 8
    if case == "shed_child_exhausted":
        assert got_rep.stats["outcomes"]["shed"] == 1 and rows[0]["detail"] == "child shed"


def test_fanout_history_series():
    pkg, mod = package("torch"), fanout("torch")
    mod.run_audit(_FakeRouter(pkg), mod.SynthCluster(resources=5, seed=6), mod.FanoutConfig())
    h = pkg.obs.history.get_history()
    h.sample()
    series = h.query(since=60.0, step=1.0)["series"]
    for name in ("fanout.active", "fanout.children_planned", "fanout.children_done",
                 "fanout.prefix_hit_rate", "fanout.children"):
        assert name in series, name
    assert series["fanout.children_done"]["points"][-1][1] == 5.0


# -- over in-process fleets -----------------------------------------------------------
ENGINE = dict(page_size=8, num_pages=512, max_pages_per_seq=64)
JAX_ENGINE = dict(prefill_buckets=(32, 64, 128))
PORT_ENGINE = dict(mixed_buckets=(16, 32, 64), max_step_tokens=128)


def _fanout_fleet(name):
    pkg = package(name)
    over = {**ENGINE, **(JAX_ENGINE if name == "jax" else PORT_ENGINE)}
    return pkg, *fleet(pkg, n=2, engine_over=over, sticky=False)


def test_fleet_audit_report_equals_jax_byte_for_byte():
    reports = {}
    for name in PKGS:
        pkg, router, stacks = _fanout_fleet(name)
        mod = fanout(name)
        try:
            cluster = mod.SynthCluster(resources=8, seed=1)
            rep = mod.run_audit(router, cluster, mod.FanoutConfig(max_inflight=4,
                                                                  max_tokens=4))
        finally:
            close(stacks)
        n = cluster.resources
        assert rep.stats["outcomes"] == {"ok": n, "shed": 0, "failed": 0}
        assert rep.stats["primes"] == 2 and rep.stats["avoided_children"] >= n - 1
        assert rep.recall(cluster) == 1.0
        reports[name] = (rep.canonical, rep.stats["shared_prefix_tokens"])
    assert reports["torch"] == reports["jax"]


def test_acceptance_gates_on_the_port():
    """``tests/test_fanout.py::_acceptance`` at 24 resources on a port fleet,
    all but its wall-clock TTFT bound."""
    pkg, router, stacks = _fanout_fleet("torch")
    mod = fanout("torch")
    try:
        for s in stacks:
            s.engine.warmup()
        cluster = mod.SynthCluster(resources=24, seed=0)
        cfg = mod.FanoutConfig(max_inflight=8, max_tokens=8)
        rep1 = mod.run_audit(router, cluster, cfg)
        list(router.complete_stream({
            "messages": [{"role": "user", "content": "warm probe"}], "max_tokens": 4,
            "temperature": 0.0, "stream": True, "slo_class": "interactive"}))
        compiles0 = pkg.obs.POST_WARMUP_COMPILES.value()
        answered, failed = [], []
        stop = threading.Event()

        def probe():
            i = 0
            while not stop.is_set():
                i += 1
                try:
                    gen = router.complete_stream({
                        "messages": [{"role": "user", "content": f"status {i}"}],
                        "max_tokens": 4, "temperature": 0.0, "stream": True,
                        "slo_class": "interactive"})
                    next(gen)
                    answered.append(i)
                    for _ in gen:
                        pass
                except Exception as e:  # noqa: BLE001 - counted below
                    failed.append(f"{type(e).__name__}: {e}")
                stop.wait(0.05)

        th = threading.Thread(target=probe, daemon=True)
        th.start()
        rep2 = mod.run_audit(router, cluster, cfg)
        stop.set()
        th.join(timeout=60)
        n = cluster.resources
        assert rep2.stats["outcomes"] == {"ok": n, "shed": 0, "failed": 0}
        assert rep2.recall(cluster) == 1.0
        assert rep2.stats["avoided_children"] >= 0.9 * n
        assert rep2.canonical == rep1.canonical
        assert pkg.obs.POST_WARMUP_COMPILES.value() - compiles0 == 0
        assert answered and not failed
    finally:
        close(stacks)


# -- the command -----------------------------------------------------------------------
def test_audit_fanout_command_json_and_exit_codes(capsys, monkeypatch):
    from opsagent_tpu_torch.cli.main import main
    from opsagent_tpu_torch.serving.fleet import router as prouter

    pkg, mod = package("jax"), fanout("jax")
    cluster = mod.SynthCluster(resources=4, seed=2)
    want = mod.run_audit(_FakeRouter(pkg), cluster, mod.FanoutConfig()).canonical
    argv = ["audit-fanout", "--resources", "4", "--seed", "2", "--device", "cpu",
            "--max-tokens", "4", "--json"]
    assert main(argv) == 0
    out = capsys.readouterr()
    assert out.out.strip().splitlines()[-1] == want
    stats = json.loads(out.err.strip().splitlines()[-1])["fanout_stats"]
    assert stats["outcomes"]["ok"] == 4 and stats["recall"] == 1.0
    # One child that always fails: contained as a row, exit 1.
    victim = cluster.work_items()[1]
    inner = prouter.FleetRouter.complete

    def complete(self, body, force_replica=None):
        if victim in body["messages"][-1]["content"]:
            raise RuntimeError("child exploded")
        return inner(self, body, force_replica=force_replica)

    monkeypatch.setattr(prouter.FleetRouter, "complete", complete)
    assert main(argv) == 1
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["summary"]["unavailable"] == 1
    assert any(f["resource"] == victim and f["issue"] == "finding_unavailable"
               for f in report["findings"])
