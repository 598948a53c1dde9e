"""Replica registry: the control-plane state the fleet router places
against (the port's copy of ``opsagent_tpu/serving/fleet/registry.py``:
the same snapshots, health walk and chain keys).

Engine replicas self-register with capacity, mesh shape, role
(decode/prefill), page geometry, and a compact prefix-trie digest (hex
chain keys of their HBM-trie + host-pool resident page chains —
Engine.prefix_digests). Registrations stay alive through heartbeats that
refresh load + digests; a replica that stops heartbeating past the
liveness TTL is reaped (its pinned sessions re-route by affinity on their
next turn — the transferred/cached pages are gone, so they re-prefill,
which is correct and merely slow). In-process replicas (LocalReplica)
mark themselves ``local`` and are polled live instead of push-heartbeated.

Affinity scoring: ``prompt_chain_keys`` digests a prompt's page-aligned
prefixes with the SAME chain-key function the host pool and HBM trie
advertisement use, and ``affinity_pages`` counts consecutive leading keys
a replica holds — longest-cached-prefix wins, in pages.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any

from ... import obs
from ...utils.logger import get_logger
from ..offload.pool import chain_key_hex
from .pagestore import PageDirectory

log = get_logger("fleet.registry")

ENV_HEARTBEAT_TTL = "OPSAGENT_FLEET_HEARTBEAT_TTL_S"
DEFAULT_HEARTBEAT_TTL_S = 10.0

ENV_EJECT_COOLDOWN = "OPSAGENT_FLEET_EJECT_COOLDOWN_S"
DEFAULT_EJECT_COOLDOWN_S = 2.0
EJECT_COOLDOWN_MAX_S = 30.0
EJECT_AFTER_FAILURES = 3      # consecutive call failures -> ejected
PROBE_TIMEOUT_S = 30.0        # a half-open probe that never reports back


def heartbeat_ttl_s(override: float | None = None) -> float:
    if override is not None and override > 0:
        return float(override)
    try:
        v = float(os.environ.get(ENV_HEARTBEAT_TTL, ""))
        if v > 0:
            return v
    except ValueError:
        pass
    return DEFAULT_HEARTBEAT_TTL_S


def eject_cooldown_s(override: float | None = None) -> float:
    if override is not None and override > 0:
        return float(override)
    try:
        v = float(os.environ.get(ENV_EJECT_COOLDOWN, ""))
        if v > 0:
            return v
    except ValueError:
        pass
    return DEFAULT_EJECT_COOLDOWN_S


@dataclass
class ReplicaHealth:
    """Circuit-breaker state for one replica, fed by router call
    outcomes (``ReplicaRegistry.note_result``) and heartbeat staleness:

        healthy --failure--> suspect --(3 consecutive)--> ejected
        ejected --cooldown--> half-open probe --success--> healthy
                                              --failure--> ejected
                                                (cooldown doubles, capped)

    Ejected replicas are excluded from admitting ``alive()`` reads until
    the cooldown elapses; then ONE in-flight probe request is admitted
    (``begin_probe``) and its outcome decides."""

    state: str = "healthy"            # healthy | suspect | ejected
    consecutive_failures: int = 0
    ejections: int = 0                # lifetime; drives cooldown backoff
    ejected_until: float = 0.0        # monotonic deadline
    probe_started: float = 0.0        # 0 = no half-open probe in flight

    def admitting(self, now: float) -> bool:
        if self.state != "ejected":
            return True
        if now < self.ejected_until:
            return False
        # Half-open: admit only while no (live) probe is in flight.
        return (
            self.probe_started == 0.0
            or now - self.probe_started > PROBE_TIMEOUT_S
        )


CLOCK_EWMA_ALPHA = 0.3            # weight of the newest heartbeat sample


@dataclass
class ClockSync:
    """Per-replica clock model from heartbeat timestamp echoes.

    Each heartbeat response carries the router's wall clock at send
    (``router_ts``); the replica echoes it on its NEXT beat together
    with how long it held it (``echo_held_s``, measured on the
    replica's monotonic clock) and its own wall clock at send
    (``replica_ts``). On receipt at router wall time ``now``:

        rtt    = (now - echo_router_ts) - echo_held_s
        offset = replica_ts - (now - rtt / 2)

    ``offset_s`` is the replica's wall clock MINUS the router's — the
    correction the fleet timeline stitcher subtracts from a replica's
    segment timestamps. Both estimates are EWMAs so one delayed beat
    cannot yank the fleet's time axis."""

    offset_s: float = 0.0
    rtt_s: float = 0.0
    samples: int = 0

    def update(self, offset_s: float, rtt_s: float) -> None:
        if self.samples == 0:
            self.offset_s, self.rtt_s = offset_s, rtt_s
        else:
            a = CLOCK_EWMA_ALPHA
            self.offset_s += a * (offset_s - self.offset_s)
            self.rtt_s += a * (rtt_s - self.rtt_s)
        self.samples += 1


def prompt_chain_keys(token_ids: list[int], page_size: int) -> list[str]:
    """Hex chain keys of every page-aligned prefix of ``token_ids[:-1]``
    (minus the last token, mirroring admission's match_prefix: at least
    one tail token always prefills to produce next-token logits)."""
    if page_size <= 0 or len(token_ids) < 2:
        return []
    usable = token_ids[: len(token_ids) - 1]
    return [
        chain_key_hex(usable[: (i + 1) * page_size])
        for i in range(len(usable) // page_size)
    ]


@dataclass
class ReplicaInfo:
    replica_id: str
    model: str = ""
    url: str = ""                  # "" for in-process handles
    role: str = "decode"           # "decode" | "prefill"
    capacity: int = 8              # max concurrent sessions (batch size)
    page_size: int = 64
    mesh: dict[str, int] = field(default_factory=dict)   # tp/sp/ep shape
    digests: set[str] = field(default_factory=set)
    digest_truncated: bool = False   # advertisement hit the digest cap
    load: dict[str, Any] = field(default_factory=dict)
    draining: bool = False
    local: bool = False            # polled live; heartbeat TTL waived
    last_heartbeat: float = field(default_factory=time.monotonic)
    handle: Any = None             # ReplicaHandle (router.py)

    def affinity_pages(self, keys: list[str]) -> int:
        """Consecutive leading prompt chain keys this replica holds —
        the longest-cached-prefix score, in pages."""
        n = 0
        for k in keys:
            if k not in self.digests:
                break
            n += 1
        return n

    def queue_depth(self) -> int:
        return int(self.load.get("queued", 0)) + int(
            self.load.get("prefilling", 0)
        )

    def load_score(self) -> float:
        """Least-loaded ordering key: running+queued sessions normalized
        by capacity, with the goodput fraction (decode-active share of
        recent wall time, from the replica's attribution snapshot) as a
        tiebreak — a replica whose wall clock is mostly queued/tool-
        blocked time scores as busier than its occupancy suggests."""
        occupied = int(self.load.get("running", 0)) + self.queue_depth()
        score = occupied / max(1, self.capacity)
        gp = self.load.get("goodput", {})
        try:
            busy = float(gp.get("queued", 0.0))
            active = float(gp.get("decode_active", 0.0))
            if busy + active > 0:
                score += busy / (busy + active) * 0.5
        except (TypeError, ValueError, AttributeError):
            pass
        return score

    def snapshot(self) -> dict[str, Any]:
        return {
            "id": self.replica_id,
            "model": self.model,
            "url": self.url,
            "role": self.role,
            "capacity": self.capacity,
            "page_size": self.page_size,
            "mesh": dict(self.mesh),
            "state": "draining" if self.draining else "active",
            "local": self.local,
            "digest_count": len(self.digests),
            "digest_truncated": self.digest_truncated,
            "load": dict(self.load),
            "heartbeat_age_s": round(
                time.monotonic() - self.last_heartbeat, 3
            ),
        }


class ReplicaRegistry:
    def __init__(
        self,
        ttl_s: float | None = None,
        eject_cooldown: float | None = None,
    ):
        self.ttl_s = heartbeat_ttl_s(ttl_s)
        self.eject_cooldown_s = eject_cooldown_s(eject_cooldown)
        self._lock = threading.Lock()
        self._replicas: dict[str, ReplicaInfo] = {}
        self._health: dict[str, ReplicaHealth] = {}
        self._clocks: dict[str, ClockSync] = {}
        self.reaped = 0
        # Fleet-global KV directory: chain_key_hex -> owning replicas,
        # kept in lockstep with the digest advertisements above.
        self.directory = PageDirectory()

    # -- membership --------------------------------------------------------
    def register(self, info: ReplicaInfo) -> None:
        with self._lock:
            info.last_heartbeat = time.monotonic()
            self._replicas[info.replica_id] = info
            # A (re-)registration is a fresh process (or an operator's
            # explicit rejoin): start from a clean health slate.
            self._health[info.replica_id] = ReplicaHealth()
            # In-process replicas share the router's clock: their offset
            # is identically zero, no echo protocol needed.
            self._clocks[info.replica_id] = (
                ClockSync(0.0, 0.0, 1) if info.local else ClockSync()
            )
        obs.FLEET_CLOCK_SKEW.set(0.0, replica=info.replica_id)
        self.directory.update(info.replica_id, info.digests)
        log.info(
            "replica %s registered (role=%s model=%s url=%s capacity=%d "
            "digests=%d)", info.replica_id, info.role, info.model,
            info.url or "<in-process>", info.capacity, len(info.digests),
        )
        self._observe()

    def heartbeat(
        self,
        replica_id: str,
        load: dict[str, Any] | None = None,
        digests: list[str] | None = None,
        digest_truncated: bool | None = None,
        replica_ts: float | None = None,
        echo_router_ts: float | None = None,
        echo_held_s: float | None = None,
    ) -> bool:
        """Refresh liveness (+ optionally load/digests). Returns False
        for unknown ids — the replica should re-register (it was reaped
        or the router restarted).

        ``replica_ts`` / ``echo_router_ts`` / ``echo_held_s`` are the
        clock-sync echo: the replica's wall clock at send, the router
        timestamp from the PREVIOUS heartbeat response, and how long
        the replica held it (monotonic). Together they yield one RTT +
        clock-offset sample (see ClockSync)."""
        with self._lock:
            info = self._replicas.get(replica_id)
            if info is None:
                return False
            info.last_heartbeat = time.monotonic()
            if (
                replica_ts is not None
                and echo_router_ts is not None
                and echo_held_s is not None
                and not info.local
            ):
                now = time.time()
                rtt = max(0.0, (now - echo_router_ts) - echo_held_s)
                offset = replica_ts - (now - rtt / 2.0)
                clock = self._clocks.setdefault(replica_id, ClockSync())
                clock.update(offset, rtt)
                obs.FLEET_CLOCK_SKEW.set(
                    clock.offset_s, replica=replica_id
                )
            if load is not None:
                info.load = dict(load)
            if digests is not None:
                info.digests = set(digests)
            if digest_truncated is not None:
                info.digest_truncated = bool(digest_truncated)
            draining = info.draining
        if digests is not None:
            # Draining replicas are already directory-invisible; keep
            # them out even if late heartbeats still advertise chains.
            self.directory.update(
                replica_id, () if draining else digests
            )
        return True

    def deregister(self, replica_id: str) -> bool:
        with self._lock:
            gone = self._replicas.pop(replica_id, None)
            self._health.pop(replica_id, None)
            self._clocks.pop(replica_id, None)
        obs.FLEET_CLOCK_SKEW.set(0.0, replica=replica_id)
        self.directory.remove_replica(replica_id)
        if gone is not None:
            log.info("replica %s deregistered", replica_id)
            self._observe()
        return gone is not None

    def set_draining(self, replica_id: str, draining: bool = True) -> bool:
        with self._lock:
            info = self._replicas.get(replica_id)
            if info is None:
                return False
            info.draining = draining
            digests = set(info.digests)
        if draining:
            # A draining replica is about to migrate its chains away
            # and exit — stop advertising it as a fault-in source.
            self.directory.remove_replica(replica_id)
        else:
            self.directory.update(replica_id, digests)
        self._observe()
        return True

    def set_role(self, replica_id: str, role: str) -> bool:
        """Reassign a replica's role router-side. The autoscaler uses
        this to promote ``standby`` replicas (request-ready but not yet
        routable — ``route()`` only considers ``decode``) into the
        decode set. Heartbeats never carry role, so the change sticks
        until the replica fully re-registers."""
        with self._lock:
            info = self._replicas.get(replica_id)
            if info is None:
                return False
            old = info.role
            info.role = role
        if old != role:
            log.info("replica %s role %s -> %s", replica_id, old, role)
        self._observe()
        return True

    # -- reads -------------------------------------------------------------
    def get(self, replica_id: str) -> ReplicaInfo | None:
        with self._lock:
            return self._replicas.get(replica_id)

    def reap(self) -> list[str]:
        """Drop replicas whose heartbeat is stale past the TTL (local
        handles are polled live and never reaped). Returns reaped ids."""
        now = time.monotonic()
        dead: list[str] = []
        with self._lock:
            for rid, info in list(self._replicas.items()):
                if info.local:
                    continue
                if now - info.last_heartbeat > self.ttl_s:
                    dead.append(rid)
                    del self._replicas[rid]
                    self._health.pop(rid, None)
                    self._clocks.pop(rid, None)
        for rid in dead:
            self.reaped += 1
            self.directory.remove_replica(rid)
            log.warning(
                "replica %s reaped (no heartbeat for > %.1fs)",
                rid, self.ttl_s,
            )
            obs.flight.record("replica_reaped", replica=rid)
        if dead:
            self._observe()
        return dead

    def refresh_local(self) -> None:
        """Poll in-process handles for live load + digests (their
        heartbeat equivalent; cheap — engine-lock reads only)."""
        with self._lock:
            locals_ = [i for i in self._replicas.values() if i.local]
        for info in locals_:
            if info.handle is None:
                continue
            try:
                info.load = info.handle.load_snapshot()
                info.digests = set(info.handle.prefix_digests())
                info.digest_truncated = bool(
                    getattr(info.handle, "digests_truncated", lambda: False)()
                )
                info.last_heartbeat = time.monotonic()
                self.directory.update(
                    info.replica_id,
                    () if info.draining else info.digests,
                )
            except Exception:  # noqa: BLE001 - a dying local replica
                log.exception(
                    "local replica %s poll failed", info.replica_id
                )

    def alive(
        self, role: str | None = None, admitting: bool = True
    ) -> list[ReplicaInfo]:
        """Live replicas, optionally filtered by role; ``admitting``
        excludes draining replicas (they finish/migrate, never admit)."""
        self.reap()
        now = time.monotonic()
        with self._lock:
            out = []
            for info in self._replicas.values():
                if role is not None and info.role != role:
                    continue
                if admitting and info.draining:
                    continue
                if not info.local and (
                    now - info.last_heartbeat > self.ttl_s
                ):
                    continue
                # Heartbeat staleness feeds the breaker: a remote replica
                # past half the TTL is suspect (still routable — the
                # liveness reap above handles full staleness).
                health = self._health.get(info.replica_id)
                if (
                    health is not None and not info.local
                    and health.state == "healthy"
                    and now - info.last_heartbeat > self.ttl_s / 2
                ):
                    health.state = "suspect"
                if admitting and health is not None \
                        and not health.admitting(now):
                    continue
                out.append(info)
            return out

    # -- circuit breaker ---------------------------------------------------
    def note_result(self, replica_id: str, ok: bool) -> None:
        """Feed one router call outcome into the replica's health state
        machine. Successes close the breaker; consecutive failures walk
        healthy -> suspect -> ejected with exponentially backed-off
        cooldowns (half-open probes readmit, see ReplicaHealth)."""
        ejected = False
        with self._lock:
            if replica_id not in self._replicas:
                return
            health = self._health.setdefault(replica_id, ReplicaHealth())
            health.probe_started = 0.0
            if ok:
                if health.state != "healthy":
                    log.info("replica %s healthy again", replica_id)
                health.state = "healthy"
                health.consecutive_failures = 0
            else:
                health.consecutive_failures += 1
                if health.state == "healthy":
                    health.state = "suspect"
                was_open = health.state == "ejected"
                if health.consecutive_failures >= EJECT_AFTER_FAILURES \
                        or was_open:
                    health.state = "ejected"
                    health.ejections += 1
                    cooldown = min(
                        self.eject_cooldown_s
                        * (2 ** max(0, health.ejections - 1)),
                        EJECT_COOLDOWN_MAX_S,
                    )
                    health.ejected_until = time.monotonic() + cooldown
                    ejected = True
        if ejected:
            log.warning(
                "replica %s ejected by circuit breaker (%d consecutive "
                "failures)", replica_id,
                self._health[replica_id].consecutive_failures,
            )
            obs.FLEET_EJECTIONS.inc()
            obs.flight.record(
                "replica_ejected", replica=replica_id,
                failures=self._health[replica_id].consecutive_failures,
                ejections=self._health[replica_id].ejections,
            )
        self._observe()

    def begin_probe(self, replica_id: str) -> None:
        """Mark the half-open probe in flight: the router calls this when
        it routes a request onto an ejected-past-cooldown replica, so
        only one probe is outstanding at a time."""
        with self._lock:
            health = self._health.get(replica_id)
            if health is not None and health.state == "ejected":
                health.probe_started = time.monotonic()

    def health_of(self, replica_id: str) -> ReplicaHealth | None:
        with self._lock:
            return self._health.get(replica_id)

    def clock_of(self, replica_id: str) -> ClockSync | None:
        with self._lock:
            return self._clocks.get(replica_id)

    def clock_offsets(self) -> dict[str, float]:
        """Per-replica clock-offset estimates in seconds (replica wall
        minus router wall); replicas without a converged estimate are
        reported at 0 — the stitcher then trusts their timestamps."""
        with self._lock:
            return {
                rid: (c.offset_s if c.samples else 0.0)
                for rid, c in self._clocks.items()
            }

    def health_snapshot(
        self, clock: bool = False
    ) -> dict[str, str] | dict[str, dict[str, Any]]:
        """Per-replica breaker state; ``clock=True`` widens each value
        to ``{"state", "clock_offset_s", "clock_rtt_s",
        "clock_samples"}`` for surfaces that also want the skew
        estimate (router /healthz, registry snapshot)."""
        with self._lock:
            if not clock:
                return {rid: h.state for rid, h in self._health.items()}
            out: dict[str, dict[str, Any]] = {}
            for rid, h in self._health.items():
                c = self._clocks.get(rid) or ClockSync()
                out[rid] = {
                    "state": h.state,
                    "clock_offset_s": round(c.offset_s, 6),
                    "clock_rtt_s": round(c.rtt_s, 6),
                    "clock_samples": c.samples,
                }
            return out

    def all(self) -> list[ReplicaInfo]:
        with self._lock:
            return list(self._replicas.values())

    def snapshot(self) -> dict[str, Any]:
        health = self.health_snapshot(clock=True)
        rows = [i.snapshot() for i in self.all()]
        for row in rows:
            h = health.get(row["id"])
            row["health"] = h["state"] if h else "healthy"
            row["clock_offset_s"] = h["clock_offset_s"] if h else 0.0
            row["clock_rtt_s"] = h["clock_rtt_s"] if h else 0.0
        return {
            "replicas": rows,
            "heartbeat_ttl_s": self.ttl_s,
            "reaped_total": self.reaped,
            "directory": self.directory.stats(),
        }

    def _observe(self) -> None:
        counts: dict[tuple[str, str], int] = {}
        for info in self.all():
            key = (info.role, "draining" if info.draining else "active")
            counts[key] = counts.get(key, 0) + 1
        for role in ("decode", "prefill", "standby"):
            for state in ("active", "draining"):
                obs.FLEET_REPLICAS.set(
                    float(counts.get((role, state), 0)),
                    role=role, state=state,
                )
        hcounts: dict[str, int] = {}
        for state in self.health_snapshot().values():
            hcounts[state] = hcounts.get(state, 0) + 1
        for state in ("healthy", "suspect", "ejected"):
            obs.FLEET_REPLICA_HEALTH.set(
                float(hcounts.get(state, 0)), state=state
            )
