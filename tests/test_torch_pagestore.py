"""The port's fleet page store (``serving/fleet/pagestore.py``) against the
JAX package's on the CPU. Tolerance: directory rows and stats, pages
landed, transfer records, flight events and greedy text are exact.

- ``PageDirectory``: one script of updates, lookups, stale invalidations
  and replica removals under a fake clock gives the same owners, stats and
  snapshots.
- ``PageStoreClient.fault_in`` over stubbed peers holding the same pages
  (records byte-equal across the packages): a whole chain, a partial one,
  the asking replica as owner, a timeout, a second peer after a failed
  first, an empty answer and a 404 (stale rows evicted), digest rejects,
  the size bound, and the ``pagestore.fetch_timeout`` and
  ``pagestore.stale_entry`` fault points: the same pages landed, stats,
  stale callbacks and ``page_fault_in`` events.
- Through the engines: a session's next turn forced onto a replica that
  never saw it faults the chain in from its owner's pool and restores it,
  and its greedy text equals a never-moved run; the same in both packages.
"""

import urllib.error

import numpy as np
import pytest
import torch

from _torch_fleet_kit import (  # noqa: F401 - port_state is an autouse fixture
    PKGS, close, events, fleet, package, port_state, stack, text)


class FakeClock:
    def __init__(self):
        self.mono = 50.0

    def monotonic(self):
        return self.mono

    def perf_counter(self):
        return self.mono


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    for name in PKGS:
        monkeypatch.setattr(package(name).pagestore, "time", c)
    return c


def _directory_script(pkg, clock) -> list:
    d = pkg.pagestore.PageDirectory()
    out = []
    d.update("a", ["k1", "k2", "k3"])
    clock.mono += 1.0
    d.update("b", ["k2", "k4"])
    out.append(d.owners(["k1", "k2", "k4", "zz"]))
    clock.mono += 1.0
    d.update("a", ["k2", "k5"])            # wholesale replacement
    out.append((d.invalidate("k2", "b"), d.invalidate("k2", "b"), d.invalidate("zz", "a")))
    out.append(d.owners(["k1", "k2", "k5"]))
    out.append(d.snapshot(limit=2))
    out.append(d.remove_replica("a"))
    out.append(d.remove_replica("ghost"))
    d.update("c", [])
    out.append((d.stats(), d.snapshot()))
    return out


def test_page_directory_script_equals_jax(clock):
    got = {}
    for name in PKGS:
        clock.mono = 50.0
        got[name] = _directory_script(package(name), clock)
    assert got["torch"] == got["jax"]


# -- fault-in over stubbed peers --------------------------------------------------
TOKS = list(range(500, 512))


def _source(pkg):
    """A peer's pool holding a 3-page chain (the same values in both
    packages) and a template of the local cache's leaves."""
    rng = np.random.default_rng(0)
    pool = pkg.pool.HostPagePool(page_size=4, capacity_bytes=1 << 20)
    for i in range(3):
        k = rng.standard_normal((2, 4, 1, 8)).astype(np.float32)
        v = rng.standard_normal((2, 4, 1, 8)).astype(np.float32)
        tree = {"k": k, "v": v} if pkg.name == "jax" else \
            {"k": torch.from_numpy(k), "v": torch.from_numpy(v)}
        assert pool.put(TOKS[: (i + 1) * 4], tree)
    if pkg.name == "jax":
        template = {"k": np.zeros(1), "v": np.zeros(1)}
    else:
        class Template:
            def page_leaves(self):
                return {"k": None, "v": None}

        template = Template()
    return pool, template


def _pack(pkg, pool, tokens, start_page):
    entries = pool.match(tokens, start_page=start_page)
    return pkg.transfer.pack_entries(entries)


CASES = ("whole", "partial", "self", "timeout", "second_peer", "empty", "404", "digest",
         "size_bound", "fault_timeout", "fault_stale")


def _fault_in_case(pkg, case) -> dict:
    src, template = _source(pkg)
    dst = pkg.pool.HostPagePool(page_size=4, capacity_bytes=1 << 20)
    evicted = []
    peers = [{"id": "peer"}]
    start, kw = 0, {}

    def fetch(owner, tokens, start_page, timeout_s):
        if case == "timeout" or (case == "second_peer" and owner["id"] == "p1"):
            raise TimeoutError("peer wedged")
        if case == "empty":
            return []
        if case == "404":
            raise urllib.error.HTTPError("http://peer", 404, "gone", None, None)
        records = _pack(pkg, src, tokens, start_page)
        if case == "digest":
            for r in records:
                r["digest"] = "00" * 16
        return records

    if case == "partial":
        start = 2
    if case == "self":
        peers = [{"id": "me"}]
    if case == "second_peer":
        peers = [{"id": "p1"}, {"id": "p2"}]
    if case == "size_bound":
        kw["max_bytes"] = pkg.transfer.records_nbytes(_pack(pkg, src, TOKS, 0)[:1])
    if case == "fault_timeout":
        pkg.faults.configure("pagestore.fetch_timeout@1+")
    if case == "fault_stale":
        pkg.faults.configure("pagestore.stale_entry@1")
    c = pkg.pagestore.PageStoreClient(
        self_id="me", page_size=4, pool=dst, template=lambda: template,
        lookup=lambda keys: {k: list(peers) for k in keys}, fetch=fetch,
        on_stale=lambda k, rid: evicted.append((k, rid)), **kw)
    landed = c.fault_in(TOKS, start_page=start, request_id="journey-1")
    pkg.faults.reset()
    snap = pkg.obs.metrics_snapshot()
    return {
        "landed": landed, "dst": sorted(dst.digests()), "stats": c.stats(),
        "evicted": evicted,
        "events": events(pkg, ("page_fault_in", "fault_injected", "anomaly")),
        "metrics": {k: v for k, v in snap.items() if k.startswith("opsagent_pagestore")
                    and "seconds" not in k},
    }


@pytest.mark.parametrize("case", CASES)
def test_fault_in_equals_jax(case):
    got = {name: _fault_in_case(package(name), case) for name in PKGS}
    assert got["torch"] == got["jax"]
    want_landed = {"whole": 3, "partial": 1, "second_peer": 3, "size_bound": 1}
    assert got["torch"]["landed"] == want_landed.get(case, 0)


def test_transfer_records_are_byte_equal_across_packages():
    recs = {name: _pack(package(name), _source(package(name))[0], TOKS, 0) for name in PKGS}
    assert recs["torch"] == recs["jax"] and len(recs["torch"]) == 3


# -- through the engines ----------------------------------------------------------------
def _forced_nonowner(pkg) -> dict:
    router, stacks = fleet(pkg)   # the page directory is on by default
    try:
        messages = [{"role": "system", "content": "pagestore acceptance"},
                    {"role": "user", "content": "first turn here"}]
        r1 = router.complete({"messages": messages, "max_tokens": 8, "temperature": 0},
                             force_replica="r0")
        messages += [{"role": "assistant", "content": text(r1)},
                     {"role": "user", "content": "second turn now"}]
        target = router.registry.get("r1").handle
        tgt0 = target.stack.engine.offload.restored_tokens
        hits0 = pkg.obs.PAGESTORE_REMOTE_HITS.value()
        r2 = router.complete({"messages": messages, "max_tokens": 8, "temperature": 0},
                             force_replica="r1")
        return {
            "turns": [text(r1), text(r2)], "fleet": r2["fleet"],
            "remote_hits": pkg.obs.PAGESTORE_REMOTE_HITS.value() - hits0,
            "restored": target.stack.engine.offload.restored_tokens - tgt0,
            "stats": target.stack.engine.pagestore.stats(),
            "misroute_pushes": pkg.obs.FLEET_MIGRATIONS.value(reason="misroute"),
            "directory": router.registry.snapshot()["directory"],
            "events": events(pkg, ("page_fault_in",)),
        }
    finally:
        close(stacks)


def _never_moved(pkg) -> list[str]:
    s = stack(pkg)
    try:
        messages = [{"role": "system", "content": "pagestore acceptance"},
                    {"role": "user", "content": "first turn here"}]
        r1 = s.chat_completion({"messages": messages, "max_tokens": 8, "temperature": 0})
        messages += [{"role": "assistant", "content": text(r1)},
                     {"role": "user", "content": "second turn now"}]
        r2 = s.chat_completion({"messages": messages, "max_tokens": 8, "temperature": 0})
        return [text(r1), text(r2)]
    finally:
        s.close()


def test_forced_nonowner_faults_in_and_matches_never_moved_run():
    want = _never_moved(package("torch"))
    assert want == _never_moved(package("jax"))
    got = {name: _forced_nonowner(package(name)) for name in PKGS}
    assert got["torch"] == got["jax"]
    g = got["torch"]
    assert g["turns"] == want and g["fleet"] == {"replica": "r1", "policy": "forced"}
    assert g["remote_hits"] > 0 and g["restored"] == 4 * g["remote_hits"]
    assert g["stats"]["remote_hit_pages"] == g["remote_hits"] and g["misroute_pushes"] == 0
    # Turn 1 found no owner (a fallback); turn 2 fetched from r0.
    assert [(e["phase"], e.get("outcome"), e.get("reason")) for e in g["events"]] == \
        [("exit", "fallback", "no_owner"), ("enter", None, None), ("exit", "hit", None)]
