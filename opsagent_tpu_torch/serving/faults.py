"""Deterministic fault injection (the port's copy of
``opsagent_tpu/serving/faults.py``): named fault points fire according to a
spec that selects by **hit count**, never by wall clock or unseeded
randomness, so the same spec against the same workload produces the same
flight-event sequence.

Spec grammar (``OPSAGENT_FAULTS`` env var, or ``configure()``):

    spec    := clause (";" clause)*
    clause  := point "@" selector
    point   := dotted fault-point name
    selector:= N          fire on the Nth hit of the point (1-based)
             | N..M       fire on hits N through M inclusive
             | N+         fire on every hit from N on
             | every:K    fire on every Kth hit
             | p:P:SEED   fire with probability P from a random.Random(SEED)
                          stream advanced once per hit (deterministic given
                          the per-point hit order)

Fault points wired in the port:

    tool.exec                 agent tool exec: subprocess failure
    tool.timeout              agent tool exec: subprocess timeout

(both in ``agent/react.py``'s blocking tool path and in
``agent/conveyor.py``'s early-launch worker). The JAX package's scheduler,
fleet and KV-transfer points come with the port's fleet router.

Every firing records a ``fault_injected`` flight event and increments
``opsagent_fault_injections_total{point=...}``.
"""

from __future__ import annotations

import os
import random
import threading
from typing import Any

from .. import obs
from ..utils.logger import get_logger

log = get_logger("faults")

ENV_FAULTS = "OPSAGENT_FAULTS"


class _Rule:
    """One parsed selector for one fault point."""

    def __init__(self, kind: str, a: float = 0, b: float = 0):
        self.kind = kind            # nth|range|from|every|prob
        self.a = a
        self.b = b
        self._rng: random.Random | None = None

    def matches(self, hit: int) -> bool:
        if self.kind == "nth":
            return hit == int(self.a)
        if self.kind == "range":
            return int(self.a) <= hit <= int(self.b)
        if self.kind == "from":
            return hit >= int(self.a)
        if self.kind == "every":
            k = int(self.a)
            return k > 0 and hit % k == 0
        if self.kind == "prob":
            if self._rng is None:
                self._rng = random.Random(int(self.b))
            # One draw per hit keeps the stream aligned with hit order.
            return self._rng.random() < self.a
        return False


def _parse_selector(sel: str) -> _Rule:
    sel = sel.strip()
    if sel.startswith("every:"):
        return _Rule("every", int(sel[len("every:"):]))
    if sel.startswith("p:"):
        _, p, seed = sel.split(":", 2)
        return _Rule("prob", float(p), int(seed))
    if sel.endswith("+"):
        return _Rule("from", int(sel[:-1]))
    if ".." in sel:
        lo, hi = sel.split("..", 1)
        return _Rule("range", int(lo), int(hi))
    return _Rule("nth", int(sel))


def parse_spec(spec: str) -> dict[str, list[_Rule]]:
    """Parse a spec string into {point: [rules]}; bad clauses are logged
    and skipped (a typo in an operator env must not take the server down)."""
    rules: dict[str, list[_Rule]] = {}
    for clause in spec.replace("\n", ";").split(";"):
        clause = clause.strip()
        if not clause:
            continue
        try:
            point, sel = clause.split("@", 1)
            rules.setdefault(point.strip(), []).append(_parse_selector(sel))
        except (ValueError, IndexError):
            log.warning("ignoring malformed fault clause %r", clause)
    return rules


class FaultInjector:
    """Process-wide injector. Hit counters are per point; the spec is
    read from ``OPSAGENT_FAULTS`` lazily (bench children set the env
    before the first hit) or pinned explicitly via ``configure()``."""

    def __init__(self, spec: str | None = None):
        self._lock = threading.Lock()
        self._explicit = spec is not None
        self._rules = parse_spec(spec or "")
        self._env_loaded = spec is not None
        self._hits: dict[str, int] = {}
        self._fired: dict[str, int] = {}

    def _load_env_locked(self) -> None:
        if self._env_loaded:
            return
        self._env_loaded = True
        spec = os.environ.get(ENV_FAULTS, "")
        if spec:
            self._rules = parse_spec(spec)
            log.info("fault injection active: %s", spec)

    def configure(self, spec: str) -> None:
        """Pin a spec (tests / bench phases); counters reset."""
        with self._lock:
            self._explicit = True
            self._env_loaded = True
            self._rules = parse_spec(spec)
            self._hits.clear()
            self._fired.clear()

    def reset(self) -> None:
        """Clear counters and unpin — the env spec re-reads on next hit."""
        with self._lock:
            self._explicit = False
            self._env_loaded = False
            self._rules = {}
            self._hits.clear()
            self._fired.clear()

    def active(self) -> bool:
        with self._lock:
            self._load_env_locked()
            return bool(self._rules)

    def fire(self, point: str, **ctx: Any) -> bool:
        """Count one hit of ``point``; True when a fault should be
        injected here. Each firing is recorded (flight event + counter)."""
        with self._lock:
            self._load_env_locked()
            rules = self._rules.get(point)
            if not rules:
                return False
            hit = self._hits.get(point, 0) + 1
            self._hits[point] = hit
            if not any(r.matches(hit) for r in rules):
                return False
            self._fired[point] = self._fired.get(point, 0) + 1
        obs.FAULT_INJECTIONS.inc(point=point)
        obs.flight.record("fault_injected", point=point, hit=hit, **ctx)
        log.warning("fault injected: %s (hit %d) %s", point, hit, ctx or "")
        return True

    def maybe_raise(
        self, point: str, exc: type[BaseException] | BaseException,
        msg: str = "", **ctx: Any,
    ) -> None:
        """``fire`` + raise: the standard wiring for a fault point whose
        failure mode is an exception."""
        if self.fire(point, **ctx):
            if isinstance(exc, BaseException):
                raise exc
            raise exc(msg or f"injected fault at {point}")

    def summary(self) -> dict[str, Any]:
        with self._lock:
            self._load_env_locked()
            return {
                "active": bool(self._rules),
                "points": sorted(self._rules),
                "hits": dict(self._hits),
                "fired": dict(self._fired),
            }


_injector = FaultInjector()


def get_injector() -> FaultInjector:
    return _injector


def configure(spec: str) -> None:
    _injector.configure(spec)


def reset() -> None:
    _injector.reset()


def active() -> bool:
    return _injector.active()


def fire(point: str, **ctx: Any) -> bool:
    return _injector.fire(point, **ctx)


def maybe_raise(
    point: str, exc: type[BaseException] | BaseException,
    msg: str = "", **ctx: Any,
) -> None:
    _injector.maybe_raise(point, exc, msg, **ctx)


def summary() -> dict[str, Any]:
    return _injector.summary()
