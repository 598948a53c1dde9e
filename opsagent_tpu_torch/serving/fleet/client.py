"""Replica-side fleet membership: ``python -m opsagent_tpu_torch
serve-engine --join-fleet <router>`` (the port's copy of
``opsagent_tpu/serving/fleet/client.py``).

Registers the engine replica with the router, then heartbeats on a
background thread — each beat refreshing the replica's load snapshot and
prefix digest so the router's affinity scores track what the trie/host
pool actually hold. A 410 from the heartbeat endpoint (reaped, or the
router restarted) triggers transparent re-registration, paced by a
jittered, capped backoff so a router restart does not get a thundering
herd of simultaneous re-registers; transport failures (``URLError`` /
``OSError`` — router blip, DNS, refused socket) never kill the
membership thread. The membership state also feeds the engine server's
``/healthz`` ``fleet`` block (replica id, role, registered-router URL,
drain state).
"""

from __future__ import annotations

import json
import random
import threading
import time
import urllib.error
import urllib.request
import uuid
from typing import Any

from ...utils.logger import get_logger
from .. import faults

log = get_logger("fleet.client")

DEFAULT_HEARTBEAT_INTERVAL_S = 3.0
# The mesh of a one-rank engine (the JAX package's replicas report their
# tp/sp/ep shape, as a port replica does its engine's, ``replica_mesh``).
SINGLE_CARD_MESH = {"tp": 1, "sp": 1, "ep": 1}


def replica_mesh(engine: Any) -> dict[str, int]:
    """The tp/sp/ep shape a replica registers: its engine's mesh."""
    mesh = getattr(engine, "mesh", None)
    if mesh is None:
        return dict(SINGLE_CARD_MESH)
    return {a: int(mesh.shape[a]) for a in SINGLE_CARD_MESH}
REGISTER_BACKOFF_BASE_S = 1.0
REGISTER_BACKOFF_CAP_S = 30.0


class FleetMembership:
    def __init__(
        self,
        stack: Any,
        router_url: str,
        advertise_url: str,
        replica_id: str = "",
        role: str = "decode",
        heartbeat_interval_s: float = DEFAULT_HEARTBEAT_INTERVAL_S,
    ):
        self.stack = stack
        self.router_url = router_url.rstrip("/")
        self.advertise_url = advertise_url.rstrip("/")
        self.replica_id = replica_id or f"replica-{uuid.uuid4().hex[:8]}"
        self.role = role
        self.heartbeat_interval_s = heartbeat_interval_s
        self.registered = False
        self.draining = False
        self.last_heartbeat_ok: bool | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # Re-registration pacing: per-replica seeded jitter decorrelates
        # a fleet's herd after a router restart without making any one
        # replica's schedule nondeterministic across its own retries.
        self._jitter = random.Random(self.replica_id)
        self._register_backoff_s = 0.0
        self._next_register_s = 0.0
        # Clock-sync echo: the router's wall clock from the last
        # register/heartbeat response, plus the local monotonic instant
        # it arrived. The NEXT beat echoes the timestamp together with
        # the held duration, giving the registry one RTT + clock-offset
        # sample per beat (registry.ClockSync).
        self._echo_router_ts: float | None = None
        self._echo_rx_mono: float = 0.0

    # -- wire ----------------------------------------------------------------
    def _post(self, path: str, body: dict[str, Any]) -> dict[str, Any]:
        req = urllib.request.Request(
            self.router_url + path,
            data=json.dumps(body).encode("utf-8"),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(  # noqa: S310 - operator URL
            req, timeout=10.0
        ) as resp:
            return json.loads(resp.read().decode("utf-8"))

    def _note_router_ts(self, resp: dict[str, Any]) -> None:
        ts = resp.get("router_ts") if isinstance(resp, dict) else None
        if isinstance(ts, (int, float)):
            self._echo_router_ts = float(ts)
            self._echo_rx_mono = time.monotonic()

    def _payload(self, full: bool) -> dict[str, Any]:
        eng = self.stack.engine
        sched = self.stack.scheduler
        load: dict[str, Any] = {
            "running": len(sched._running),
            "queued": len(sched._waiting) + sched._queue.qsize(),
            "prefilling": len(sched._prefilling),
            "free_pages": eng.alloc.free_pages,
        }
        if getattr(eng, "offload", None) is not None:
            load["host_pool_pages"] = eng.offload.pool.num_pages
        body: dict[str, Any] = {
            "replica_id": self.replica_id,
            "load": load,
            "digests": eng.prefix_digests(),
            "digest_truncated": bool(
                getattr(eng, "digests_truncated", lambda: False)()
            ),
            "replica_ts": time.time(),
        }
        if self._echo_router_ts is not None:
            body["echo_router_ts"] = self._echo_router_ts
            body["echo_held_s"] = time.monotonic() - self._echo_rx_mono
        if full:
            body.update({
                "url": self.advertise_url,
                "model": self.stack.model_name,
                "role": self.role,
                "capacity": int(eng.cfg.max_batch_size),
                "page_size": int(eng.cfg.page_size),
                "mesh": replica_mesh(eng),
            })
        return body

    # -- lifecycle -----------------------------------------------------------
    def register(self) -> bool:
        try:
            self._note_router_ts(
                self._post("/fleet/register", self._payload(full=True))
            )
        except Exception as e:  # noqa: BLE001 - router may not be up yet
            log.warning("fleet registration failed (will retry): %s", e)
            self.registered = False
            # Jittered, capped backoff before the next attempt.
            self._register_backoff_s = min(
                REGISTER_BACKOFF_CAP_S,
                (self._register_backoff_s or REGISTER_BACKOFF_BASE_S) * 2,
            )
            self._next_register_s = time.monotonic() + \
                self._register_backoff_s * self._jitter.uniform(0.5, 1.5)
            return False
        self.registered = True
        self._register_backoff_s = 0.0
        self._next_register_s = 0.0
        log.info(
            "joined fleet at %s as %s (role=%s)",
            self.router_url, self.replica_id, self.role,
        )
        return True

    def start(self) -> None:
        if self._thread is not None:
            return
        self.register()
        self._thread = threading.Thread(
            target=self._beat_loop, daemon=True, name="fleet-heartbeat"
        )
        self._thread.start()

    def _beat_loop(self) -> None:
        while not self._stop.wait(self.heartbeat_interval_s):
            if self.draining:
                # Drained (POST /fleet/drain): the router deregistered
                # this replica on purpose — re-registering would undo the
                # drain. In-flight work finishes; the process is expected
                # to exit (or an operator clears .draining to rejoin).
                continue
            if not self.registered:
                if time.monotonic() >= self._next_register_s:
                    self.register()
                continue
            if faults.fire("client.heartbeat_drop", replica=self.replica_id):
                # Injected: this beat is silently lost in transit. The
                # router sees a stale heartbeat (suspect past ttl/2,
                # reaped past ttl); the replica just beats again.
                self.last_heartbeat_ok = False
                continue
            try:
                self._note_router_ts(
                    self._post(
                        "/fleet/heartbeat", self._payload(full=False)
                    )
                )
                self.last_heartbeat_ok = True
            except urllib.error.HTTPError as e:
                self.last_heartbeat_ok = False
                if e.code == 410:
                    # Reaped / router restarted: re-register next beat.
                    self.registered = False
            except (urllib.error.URLError, OSError):
                # Router blip (refused socket, DNS, reset): the thread
                # must survive — connectivity usually comes back.
                self.last_heartbeat_ok = False
            except Exception:  # noqa: BLE001 - router briefly unreachable
                self.last_heartbeat_ok = False

    def promote(self, role: str = "decode") -> None:
        """Accept a router-side role change (POST /fleet/promote on the
        engine server). Heartbeats never carry role, so the only way the
        promotion could revert is a full re-register — which now carries
        the new role too."""
        old, self.role = self.role, role
        if old != role:
            log.info(
                "replica %s promoted: role %s -> %s",
                self.replica_id, old, role,
            )

    def stop(self, deregister: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if deregister and self.registered:
            try:
                self._post(
                    "/fleet/deregister", {"replica_id": self.replica_id}
                )
            except Exception:  # noqa: BLE001
                pass
            self.registered = False

    # -- /healthz fleet block -------------------------------------------------
    def healthz_block(self) -> dict[str, Any]:
        return {
            "replica_id": self.replica_id,
            "role": self.role,
            "router_url": self.router_url,
            "registered": self.registered,
            "draining": self.draining,
            "last_heartbeat_ok": self.last_heartbeat_ok,
        }
