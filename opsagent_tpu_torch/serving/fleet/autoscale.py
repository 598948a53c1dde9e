"""Elastic fleet autoscaling: shed pressure -> standby replicas (the port's
counterpart of ``opsagent_tpu/serving/fleet/autoscale.py``, the same policy).

The scaling loop closes over signals the fleet already emits: the router's
shed decision (``FleetRouter._check_overload``, every decode queue at the
watermark) is the scale-up trigger, sustained idleness of a scaler-launched
replica is the scale-down trigger, and scale-down itself is the router's
graceful drain (``FleetRouter.drain``), so no session sees an error when
capacity leaves.

A standby launched with ``serve-engine --restore-snapshot`` maps the
snapshot's weights and pre-seeds its kernel libraries (no ``nvcc`` runs), so
it reaches request-ready within the window a traffic spike lasts. Launched
replicas join with ``role="standby"`` (``route()`` considers ``decode``
only), and the scaler promotes them once ``/healthz`` says request-ready, so
a half-initialized engine never receives traffic.

``ReplicaLauncher`` is the placement boundary: ``SubprocessLauncher`` spawns
``python -m opsagent_tpu_torch serve-engine`` processes on this host (each
with a CUDA context of its own on the card), ``LocalStackLauncher`` builds
in-process stacks (tests).
"""

from __future__ import annotations

import json as _json
import subprocess
import sys
import threading
import time
import urllib.request
from typing import Any, Callable

from ... import obs
from ...utils.logger import get_logger

log = get_logger("autoscale")


class ReplicaLauncher:
    """Minimal placement interface the Autoscaler drives."""

    def launch(self, replica_id: str) -> None:
        """Start a replica that will (eventually) appear in the router's
        registry with ``role="standby"``. Must not block on init."""
        raise NotImplementedError

    def request_ready(self, replica_id: str) -> bool:
        """True once the replica can serve requests (weights on the device,
        warmup done)."""
        raise NotImplementedError

    def stop(self, replica_id: str) -> None:
        """Tear the replica down (after the router has drained it)."""
        raise NotImplementedError


class LocalStackLauncher(ReplicaLauncher):
    """In-process launcher for tests: ``stack_factory()`` returns a ready
    ServingStack (e.g. built around ``Engine.from_snapshot``)."""

    def __init__(self, router: Any, stack_factory: Callable[[], Any]):
        self.router = router
        self.stack_factory = stack_factory
        self._stacks: dict[str, Any] = {}

    def launch(self, replica_id: str) -> None:
        stack = self.stack_factory()
        self._stacks[replica_id] = stack
        self.router.add_local(stack, replica_id, role="standby")

    def request_ready(self, replica_id: str) -> bool:
        return replica_id in self._stacks

    def stop(self, replica_id: str) -> None:
        stack = self._stacks.pop(replica_id, None)
        if stack is not None:
            stack.close()


class SubprocessLauncher(ReplicaLauncher):
    """Launch standby replicas as serve-engine subprocesses restoring from a
    snapshot, joining the fleet over HTTP on sequential ports.
    ``popen_kw`` passes to ``subprocess.Popen`` (e.g. ``stdout``, ``env``)."""

    def __init__(
        self,
        snapshot_path: str,
        router_url: str,
        host: str = "127.0.0.1",
        port_base: int = 8400,
        **popen_kw: Any,
    ):
        self.snapshot_path = snapshot_path
        self.router_url = router_url
        self.host = host
        self.port_base = port_base
        self.popen_kw = popen_kw
        self._procs: dict[str, subprocess.Popen] = {}
        self._urls: dict[str, str] = {}
        self._next_port = port_base

    def command(self, replica_id: str, port: int) -> list[str]:
        """The serve-engine command line of one standby."""
        url = f"http://{self.host}:{port}"
        return [
            sys.executable, "-m", "opsagent_tpu_torch", "serve-engine",
            "--restore-snapshot", self.snapshot_path,
            "--host", self.host, "--port", str(port),
            "--join-fleet", self.router_url,
            "--advertise", url,
            "--replica-id", replica_id,
            "--replica-role", "standby",
        ]

    def launch(self, replica_id: str) -> None:
        port = self._next_port
        self._next_port += 1
        self._procs[replica_id] = subprocess.Popen(
            self.command(replica_id, port), **self.popen_kw)
        self._urls[replica_id] = f"http://{self.host}:{port}"
        log.info(
            "launched standby %s on %s (pid %d, snapshot %s)",
            replica_id, self._urls[replica_id], self._procs[replica_id].pid,
            self.snapshot_path,
        )

    def url_of(self, replica_id: str) -> str | None:
        return self._urls.get(replica_id)

    def request_ready(self, replica_id: str) -> bool:
        url = self._urls.get(replica_id)
        proc = self._procs.get(replica_id)
        if url is None or proc is None or proc.poll() is not None:
            return False
        try:
            with urllib.request.urlopen(url + "/healthz", timeout=2) as r:
                return _json.loads(r.read()).get("status") == "ok"
        except Exception:  # noqa: BLE001 - still booting
            return False

    def stop(self, replica_id: str) -> None:
        proc = self._procs.pop(replica_id, None)
        self._urls.pop(replica_id, None)
        if proc is None or proc.poll() is not None:
            return
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)


class Autoscaler:
    """Shed-driven scale-up, idleness-driven scale-down.

    One launch is in flight at a time (a standby that has not been promoted
    yet absorbs the pressure signal), bounded by ``max_replicas``
    scaler-launched replicas and a post-launch ``cooldown_s``. Tests drive
    ``tick()`` directly; ``start()`` runs it on a daemon thread every
    ``interval_s``."""

    def __init__(
        self,
        router: Any,
        launcher: ReplicaLauncher,
        max_replicas: int = 4,
        cooldown_s: float = 30.0,
        queue_high: int | None = None,
        scale_down_after: int = 10,
        interval_s: float = 2.0,
    ):
        self.router = router
        self.launcher = launcher
        self.max_replicas = max_replicas
        self.cooldown_s = cooldown_s
        self.queue_high = queue_high
        self.scale_down_after = scale_down_after
        self.interval_s = interval_s
        self._lock = threading.Lock()
        self._shed = 0
        self._shed_by_class: dict[str, int] = {}
        self._seq = 0
        # -inf, not 0.0: monotonic() counts from boot, so on a freshly
        # booted host 0.0 would put the first launch inside the cooldown.
        self._last_launch = float("-inf")
        self._pending: set[str] = set()    # launched, not yet promoted
        self._active: set[str] = set()     # promoted, scaler-owned
        self._idle_ticks: dict[str, int] = {}
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self.launched_total = 0
        self.promoted_total = 0
        self.retired_total = 0

    # -- signals -----------------------------------------------------------
    def note_shed(self, slo_class: str = "") -> None:
        """Called by ``FleetRouter._check_overload`` on every shed 429, with
        the SLO class of the request turned away, so that the scale-up
        decision says whose backlog triggered it."""
        with self._lock:
            self._shed += 1
            cls = slo_class or "interactive"
            self._shed_by_class[cls] = self._shed_by_class.get(cls, 0) + 1

    def _take_shed(self) -> tuple[int, dict[str, int]]:
        with self._lock:
            n, self._shed = self._shed, 0
            by_class, self._shed_by_class = self._shed_by_class, {}
            return n, by_class

    # -- the loop ----------------------------------------------------------
    def tick(self) -> dict[str, Any]:
        """One scaling decision. Returns what it did."""
        reg = self.router.registry
        reg.refresh_local()
        out: dict[str, Any] = {"promoted": [], "launched": None, "retired": []}

        # 1) Promote request-ready standbys into the routable decode set.
        for info in list(reg.alive(role="standby")):
            rid = info.replica_id
            if rid in self._pending and not self.launcher.request_ready(rid):
                continue
            if not reg.set_role(rid, "decode"):
                continue
            if info.handle is not None:
                # Keep the handle's self-reported role consistent so that a
                # registry re-register from info() does not demote it.
                info.handle.role = "decode"
            self._pending.discard(rid)
            self._active.add(rid)
            self._idle_ticks[rid] = 0
            self.promoted_total += 1
            obs.FLEET_SCALE_EVENTS.inc(direction="promote")
            obs.flight.record("replica_promote", replica=rid)
            log.info("standby %s promoted to decode", rid)
            out["promoted"].append(rid)

        # 2) Scale up on pressure.
        shed, shed_by_class = self._take_shed()
        decode = reg.alive(role="decode")
        depths = [c.queue_depth() for c in decode]
        pressure = shed > 0 or (
            self.queue_high is not None and depths and min(depths) >= self.queue_high
        )
        fleet_size = len(self._pending) + len(self._active)
        now = time.monotonic()
        if (
            pressure
            and not self._pending
            and fleet_size < self.max_replicas
            and now - self._last_launch >= self.cooldown_s
        ):
            self._seq += 1
            rid = f"scale-{self._seq}"
            try:
                self.launcher.launch(rid)
            except Exception:  # noqa: BLE001 - launch is best-effort
                log.exception("standby launch %s failed", rid)
            else:
                self._pending.add(rid)
                self._last_launch = now
                self.launched_total += 1
                obs.FLEET_SCALE_EVENTS.inc(direction="up")
                # The dominant class in this window's shed tally (ties break
                # by name).
                trigger_class = (
                    max(sorted(shed_by_class), key=lambda c: shed_by_class[c])
                    if shed_by_class else ""
                )
                obs.flight.record(
                    "replica_launch", replica=rid, shed_events=shed,
                    min_queue_depth=min(depths) if depths else -1,
                    trigger_class=trigger_class, shed_by_class=shed_by_class,
                )
                log.info(
                    "scale-up: launching %s (shed=%d, class=%s, min queue=%s)",
                    rid, shed, trigger_class or "n/a", min(depths) if depths else "n/a",
                )
                out["launched"] = rid

        # 3) Scale down scaler-owned replicas that sat idle long enough. The
        #    drain is graceful (sessions migrate), so a request slipping in
        #    between the check and the drain is safe.
        if not pressure:
            by_id = {c.replica_id: c for c in decode}
            for rid in list(self._active):
                info = by_id.get(rid)
                if info is None:
                    self._active.discard(rid)
                    self._idle_ticks.pop(rid, None)
                    continue
                if info.queue_depth() == 0 and not info.draining:
                    self._idle_ticks[rid] = self._idle_ticks.get(rid, 0) + 1
                else:
                    self._idle_ticks[rid] = 0
                if self._idle_ticks[rid] >= self.scale_down_after:
                    try:
                        self.router.drain(rid)
                    except Exception:  # noqa: BLE001
                        log.exception("scale-down drain of %s failed", rid)
                        continue
                    self.launcher.stop(rid)
                    self._active.discard(rid)
                    self._idle_ticks.pop(rid, None)
                    self.retired_total += 1
                    obs.FLEET_SCALE_EVENTS.inc(direction="down")
                    obs.flight.record("replica_retire", replica=rid)
                    log.info("scale-down: retired idle replica %s", rid)
                    out["retired"].append(rid)
        else:
            for rid in self._idle_ticks:
                self._idle_ticks[rid] = 0
        return out

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            shed_pending = self._shed
            shed_by_class = dict(self._shed_by_class)
        return {
            "max_replicas": self.max_replicas,
            "pending": sorted(self._pending),
            "active": sorted(self._active),
            "shed_pending": shed_pending,
            "shed_pending_by_class": shed_by_class,
            "launched_total": self.launched_total,
            "promoted_total": self.promoted_total,
            "retired_total": self.retired_total,
        }

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def _run() -> None:
            while not self._stop.wait(self.interval_s):
                try:
                    self.tick()
                except Exception:  # noqa: BLE001 - keep the loop alive
                    log.exception("autoscaler tick failed")

        self._thread = threading.Thread(target=_run, name="autoscaler", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        for rid in list(self._pending) + list(self._active):
            try:
                self.launcher.stop(rid)
            except Exception:  # noqa: BLE001
                log.exception("launcher stop of %s failed", rid)
