"""Serving flight recorder: a bounded ring of structured engine /
scheduler / server events, auto-dumped to JSONL on anomaly (the port's
copy of ``opsagent_tpu/obs/flight.py``, with its own compile watchdog).

Metrics answer "how slow" (histograms, counters) and traces answer "where
inside one request" — neither answers "what happened in the seconds
BEFORE it got slow": what the dispatch composition was, whether a
post-warmup capture landed, whether a request failed, which requests were
admitted and in what order. The flight recorder keeps that context
resident so the diagnosis is one endpoint read.

Design:

- **Bounded + cheap**: one ``deque(maxlen=...)`` append under a lock per
  event; events are plain dicts (monotonic ``ts`` for ordering, wall
  ``wall`` for correlating with external logs). The hot loop records one
  event per *device dispatch*, not per token, so the overhead is noise
  next to the dispatch itself.
- **Recorded from every layer**: admission / dispatch composition /
  preemption / prefix eviction / finish (engine), restart + request
  errors (scheduler), tool execution (agent loop), compile events
  (compile watchdog below).
- **Dumpable**: ``GET /api/debug/flight`` on both servers returns the
  ring; on anomaly the ring is written to a JSONL file under
  ``$OPSAGENT_FLIGHT_DIR`` (default ``logs/flight``) so a crash or
  restart cannot lose the context that explains it. Unlike the JAX
  package, the caller only copies the ring: a writer thread serializes
  it, assembles the dump's context and writes the file (tens of ms of
  host work that would otherwise land inside the mixed tick whose first
  token breached TTFT). ``wait_dumps`` joins the writers.

Anomaly triggers (each rate-limited so a storm cannot fill the disk):

- a **post-warmup compile**: a CUDA-graph capture or an ``nvcc`` build
  that a serving window pays for;
- **TTFT over threshold** (``$OPSAGENT_SLO_TTFT_MS``, default 500 — the
  north-star p50 target doubles as the per-request alarm line);
- an **engine restart** (slice-restart recovery engaged);
- a **request error** (admission failure / stream-callback death).

The compile watchdog also lives here. The port's counterparts of an XLA
compile are a CUDA-graph capture (``StepGraph.__init__``,
serving/decode_graph.py) and an ``nvcc`` build of a kernel source
(``ops/cuda_build.py`` ``build``). Both call ``on_compile(duration_s)``,
which feeds the labeled compile counters/histograms so "zero post-warmup
compiles" is a live ``/metrics`` gauge (``opsagent_post_warmup_compiles``)
instead of a test-only assertion. ``Engine.warmup`` wraps its body in
``warmup_phase()``; compiles before the first completed warmup count as
phase "startup", compiles inside it as "warmup", and anything after is
"serving" — an anomaly.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Iterator

from ..utils.logger import get_logger

log = get_logger("obs.flight")

_ENV_DIR = "OPSAGENT_FLIGHT_DIR"
_ENV_CAPACITY = "OPSAGENT_FLIGHT_CAPACITY"
_ENV_DUMP_INTERVAL = "OPSAGENT_FLIGHT_DUMP_INTERVAL_S"
_ENV_TTFT_MS = "OPSAGENT_SLO_TTFT_MS"
_ENV_SAMPLE = "OPSAGENT_FLIGHT_SAMPLE"
_ENV_ANOMALY_HOLD = "OPSAGENT_FLIGHT_ANOMALY_HOLD_S"

DEFAULT_CAPACITY = 2048
DEFAULT_DUMP_INTERVAL_S = 5.0
DEFAULT_ANOMALY_HOLD_S = 2.0
# Ring events a dump writer serializes between two yields of the
# interpreter lock (each ~0.2 ms of host work).
DUMP_YIELD_EVENTS = 16


def _parse_sample_spec(spec: str) -> dict[str, int]:
    """``"admission=8,dispatch=16"`` -> per-kind keep-1-in-N rates.
    Rates <= 1 (and junk) are dropped: 1-in-1 is just "record"."""
    rates: dict[str, int] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        kind, _, val = part.partition("=")
        try:
            rate = int(val)
        except ValueError:
            continue
        if kind.strip() and rate > 1:
            rates[kind.strip()] = rate
    return rates


def flight_dir() -> str:
    return os.environ.get(_ENV_DIR) or "logs/flight"


def ttft_threshold_s() -> float:
    """The per-request TTFT alarm line in seconds (the p50 SLO target
    doubles as the anomaly trigger: any single request past it is worth a
    ring dump, because p50 breaches are made of such requests)."""
    try:
        return float(os.environ.get(_ENV_TTFT_MS, "500")) / 1e3
    except ValueError:
        return 0.5


class FlightRecorder:
    """Thread-safe bounded event ring with anomaly-triggered JSONL dumps."""

    def __init__(
        self,
        capacity: int | None = None,
        dump_interval_s: float | None = None,
    ):
        if capacity is None:
            try:
                capacity = int(os.environ.get(_ENV_CAPACITY, ""))
            except ValueError:
                capacity = 0
            capacity = capacity or DEFAULT_CAPACITY
        self.capacity = capacity
        self.dump_interval_s = (
            DEFAULT_DUMP_INTERVAL_S if dump_interval_s is None
            else dump_interval_s
        )
        self._lock = threading.Lock()
        self._ring: deque[dict[str, Any]] = deque(maxlen=capacity)
        self._seq = 0              # monotonically increasing event id
        self._dropped = 0          # events evicted by the ring bound
        self._anomalies = 0
        self._last_dump_s = 0.0    # perf_counter of the last JSONL dump
        self.last_dump_path: str | None = None
        self._writers: list[threading.Thread] = []
        # Flood control: a fan-out admission wave emits thousands of
        # admission/dispatch events in seconds — enough to wrap the ring
        # and evict the anomaly context it exists to keep. Per-kind
        # keep-1-in-N sampling throttles the high-volume kinds; for
        # ``anomaly_hold_s`` after any anomaly the sampling is suspended
        # so anomaly-adjacent events are always retained verbatim.
        self._sample_rates = _parse_sample_spec(
            os.environ.get(_ENV_SAMPLE, "")
        )
        self._kind_seen: dict[str, int] = {}
        self._sampled_out: dict[str, int] = {}
        self._retain_until = 0.0   # perf_counter deadline of the hold-off
        try:
            self.anomaly_hold_s = float(
                os.environ.get(_ENV_ANOMALY_HOLD, "")
            )
        except ValueError:
            self.anomaly_hold_s = DEFAULT_ANOMALY_HOLD_S

    # -- recording ---------------------------------------------------------
    def set_sample_rate(self, kind: str, rate: int) -> None:
        """Keep 1 in ``rate`` events of ``kind`` (rate <= 1 restores
        full recording). The fan-out orchestrator raises rates on the
        high-volume kinds for the duration of its admission wave."""
        with self._lock:
            if rate > 1:
                self._sample_rates[kind] = int(rate)
            else:
                self._sample_rates.pop(kind, None)
                self._kind_seen.pop(kind, None)

    def record(self, kind: str, **fields: Any) -> dict[str, Any]:
        """Append one event. ``fields`` must be JSON-serializable (the
        dump path str()s anything that is not, rather than losing the
        ring to one exotic attr). Kinds under a sample rate are recorded
        1-in-N (suppressed events are counted in stats, not ringed),
        except inside the post-anomaly hold-off window, where everything
        is retained."""
        ev = {
            "ts": time.perf_counter(),
            "wall": time.time(),
            "kind": kind,
        }
        ev.update(fields)
        with self._lock:
            rate = self._sample_rates.get(kind)
            if rate and ev["ts"] >= self._retain_until:
                seen = self._kind_seen.get(kind, 0)
                self._kind_seen[kind] = seen + 1
                if seen % rate != 0:
                    self._sampled_out[kind] = \
                        self._sampled_out.get(kind, 0) + 1
                    return ev
            self._seq += 1
            ev["id"] = self._seq
            if len(self._ring) == self.capacity:
                self._dropped += 1
            self._ring.append(ev)
        return ev

    def anomaly(
        self, reason: str, count: bool = True, **fields: Any
    ) -> str | None:
        """Record an anomaly event and dump the ring to JSONL (rate-
        limited). Returns the dump path, or None when rate-limited /
        dump-failed. Never raises: the flight recorder must not add a
        failure mode to the path it is observing. ``count=False`` skips
        the opsagent_anomalies_total increment — for callers that run at
        SCRAPE time (the SLO collector), where mutating a scrape-visible
        counter would make consecutive renders of an idle registry
        disagree."""
        # Anomaly-adjacent events must survive flood control: suspend
        # per-kind sampling for the hold-off window so the events that
        # explain (and follow) the anomaly land in the ring verbatim.
        with self._lock:
            self._retain_until = max(
                self._retain_until,
                time.perf_counter() + self.anomaly_hold_s,
            )
        ev = self.record("anomaly", reason=reason, **fields)
        if count:
            try:
                from . import ANOMALIES

                ANOMALIES.inc(reason=reason)
            except Exception:  # noqa: BLE001
                pass
        # Anomalies pin traces: tail-based retention must keep the trace
        # of any request that breached/errored, and every per-request
        # anomaly caller already passes request_id here — one hook covers
        # ttft_breach, request_error, admission_failed, and slo_breach.
        try:
            from . import trace as _trace

            _trace.mark_anomalous(fields.get("request_id"), reason=reason)
        except Exception:  # noqa: BLE001
            pass
        now = time.perf_counter()
        with self._lock:
            if now - self._last_dump_s < self.dump_interval_s:
                return None
            self._last_dump_s = now
        try:
            return self._dump_async(reason, ev)
        except Exception as e:  # noqa: BLE001 - observability must not kill serving
            log.warning("flight dump failed: %s", e)
            return None

    def _dump_async(self, reason: str, trigger: dict[str, Any]) -> str:
        """Copy the ring and hand it to a writer thread; returns the path
        the dump is written to."""
        stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
        path = os.path.join(
            flight_dir(), f"flight-{stamp}-{trigger['id']}-{_slug(reason)}.jsonl"
        )
        head = {
            "kind": "dump_header",
            "reason": reason,
            "trigger_id": trigger["id"],
            "wall": time.time(),
            "dropped": self._dropped,
            "capacity": self.capacity,
        }
        writer = threading.Thread(
            target=self._dump_jsonl, args=(path, head, self.snapshot(), trigger),
            name="flight-dump",
        )
        with self._lock:
            self._writers = [t for t in self._writers if t.is_alive()] + [writer]
        writer.start()
        self.last_dump_path = path
        return path

    def _dump_jsonl(
        self, path: str, head: dict[str, Any], events: list[dict[str, Any]],
        trigger: dict[str, Any],
    ) -> None:
        """The writer thread: the ring as it stood at the anomaly, then
        the context. It hands the interpreter lock back every
        ``DUMP_YIELD_EVENTS`` events, so the serving thread, which wants it
        between device waits, does not queue behind a whole dump. A
        failure is logged, never raised."""
        encode = json.JSONEncoder(default=str).encode
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w") as f:
                f.write(encode({**head, "events": len(events)}) + "\n")
                for i, ev in enumerate(events):
                    f.write(encode(ev) + "\n")
                    if i % DUMP_YIELD_EVENTS == 0:
                        time.sleep(0)
                time.sleep(0)
                for extra in self._dump_context(trigger):
                    f.write(encode(extra) + "\n")
        except Exception as e:  # noqa: BLE001 - observability must not kill serving
            log.warning("flight dump failed: %s", e)
            return
        log.warning(
            "flight recorder dumped %d events to %s (reason: %s)",
            len(events), path, head["reason"],
        )

    def wait_dumps(self, timeout: float | None = None) -> None:
        """Join the dump writers started so far."""
        with self._lock:
            writers = list(self._writers)
        for t in writers:
            t.join(timeout)

    def _dump_context(self, trigger: dict[str, Any]) -> list[dict[str, Any]]:
        """Postmortem context appended to every anomaly dump so the JSONL
        is self-contained: the goodput ledger's attribution snapshot
        (bytes-by-kind, MFU, drift — where THIS window's device time was
        going), and, when the trigger names a request, that request's
        assembled timeline (SLO-breach and TTFT-breach dumps then carry
        the whole story: ring + attribution + per-phase wall clock).
        Best-effort: a failure here must never lose the event dump."""
        out: list[dict[str, Any]] = []
        try:
            from . import attribution

            out.append({
                "kind": "attribution_snapshot", **attribution.snapshot(),
            })
        except Exception:  # noqa: BLE001
            pass
        try:
            from . import history as _history

            # The last 60 s of every tracked series at the 1 s tier: the
            # lead-up to the anomaly (goodput collapse, queue growth, a
            # shed burst) rides the dump, so a postmortem needs no live
            # scrape to see the trajectory.
            h = _history.get_history().query(since=60.0, step=1.0)
            if any(s["points"] for s in h.get("series", {}).values()):
                out.append({"kind": "history", **h})
        except Exception:  # noqa: BLE001
            pass
        rid = trigger.get("request_id")
        if rid:
            try:
                from . import timeline

                tl = timeline.assemble(rid)
                if tl is not None:
                    tl.pop("events", None)  # the ring is already the dump
                    out.append({"kind": "timeline", **tl})
            except Exception:  # noqa: BLE001
                pass
            if _journey_provider is not None:
                # Fleet context: when a router lives in this process its
                # participants map knows which replicas served this
                # request and through which hops — the cross-replica
                # journey of the triggering request rides in the dump.
                try:
                    j = _journey_provider(rid)
                    if j:
                        out.append({
                            "kind": "fleet_journey", "request_id": rid,
                            **j,
                        })
                except Exception:  # noqa: BLE001
                    pass
        return out

    # -- reading -----------------------------------------------------------
    def snapshot(
        self, n: int | None = None, kind: str | None = None
    ) -> list[dict[str, Any]]:
        """The newest-last event list; ``n`` caps to the newest n after
        the optional kind filter."""
        with self._lock:
            events: Iterator[dict[str, Any]] | list = list(self._ring)
        if kind:
            events = [e for e in events if e.get("kind") == kind]
        if n is not None and n >= 0:
            events = list(events)[-n:]
        return list(events)

    def stats(self) -> dict[str, Any]:
        with self._lock:
            return {
                "events": len(self._ring),
                "capacity": self.capacity,
                "total_recorded": self._seq,
                "dropped": self._dropped,
                "sampled_out": dict(self._sampled_out),
                "sample_rates": dict(self._sample_rates),
                "last_dump_path": self.last_dump_path,
            }

    def reset(self) -> None:
        """Test-isolation hook: clear the ring, the dump rate limit, and
        the flood-control state (rates re-read from the environment)."""
        with self._lock:
            self._ring.clear()
            self._seq = 0
            self._dropped = 0
            self._last_dump_s = 0.0
            self.last_dump_path = None
            self._sample_rates = _parse_sample_spec(
                os.environ.get(_ENV_SAMPLE, "")
            )
            self._kind_seen.clear()
            self._sampled_out.clear()
            self._retain_until = 0.0


_recorder: FlightRecorder | None = None
_recorder_lock = threading.Lock()

# Optional fleet-journey lookup (request_id -> journey dict or None).
# A FleetRouter in this process registers its participants map here so
# anomaly dumps carry the cross-replica story of the triggering request.
_journey_provider: Any = None


def set_journey_provider(fn: Any) -> None:
    global _journey_provider
    _journey_provider = fn


def get_recorder() -> FlightRecorder:
    global _recorder
    if _recorder is None:
        with _recorder_lock:
            if _recorder is None:
                _recorder = FlightRecorder()
    return _recorder


def record(kind: str, **fields: Any) -> None:
    """Module-level convenience onto the process-wide recorder."""
    get_recorder().record(kind, **fields)


def anomaly(reason: str, **fields: Any) -> str | None:
    return get_recorder().anomaly(reason, **fields)


def _slug(s: str) -> str:
    return "".join(c if c.isalnum() or c in "-_" else "-" for c in s)[:48]


def request_id_of(span: Any) -> str | None:
    """The request ID behind an engine/scheduler span handle (obs.trace
    Span), or None. Events carry it so a dump can be filtered to one
    request's life."""
    try:
        return span.trace.request_id if span is not None else None
    except AttributeError:
        return None


# -- compile watchdog ---------------------------------------------------------
#
# The JAX package listens to jax.monitoring for backend compiles. The port
# has two sources of the same cost, each reporting itself here: a CUDA-graph
# capture of a serving step (StepGraph.__init__) and an nvcc build of a
# kernel source (ops/cuda_build.build; a build that finds its library
# already built is a cache hit and compiles nothing). Each becomes labeled
# /metrics instruments and a flight-ring event, and one landing AFTER a
# completed warmup is an anomaly.

_warmup_depth = 0          # >0 while Engine.warmup() runs (any engine)
_warmed = False            # at least one warmup completed in this process
_watch_lock = threading.Lock()


def compile_phase() -> str:
    """Phase label for a compile landing now: "warmup" inside a warmup
    call, "serving" after the first completed warmup (the anomalous
    case), "startup" before any warmup (unwarmed engines capture lazily
    by design)."""
    with _watch_lock:
        if _warmup_depth > 0:
            return "warmup"
        return "serving" if _warmed else "startup"


class warmup_phase:
    """Context manager bracketing Engine.warmup(): compiles inside count
    as phase "warmup"; on exit the process is marked warmed, so later
    compiles are "serving" anomalies. Re-entrant across engines."""

    def __enter__(self) -> "warmup_phase":
        global _warmup_depth
        with _watch_lock:
            _warmup_depth += 1
        return self

    def __exit__(self, *exc: Any) -> None:
        global _warmup_depth, _warmed
        with _watch_lock:
            _warmup_depth = max(0, _warmup_depth - 1)
            if exc[0] is None:
                _warmed = True


def warmed() -> bool:
    with _watch_lock:
        return _warmed


def reset_compile_watchdog() -> None:
    """Test-isolation hook: forget the warmed state so one test's warmup
    cannot turn every later test's lazy capture into an anomaly."""
    global _warmup_depth, _warmed
    with _watch_lock:
        _warmup_depth = 0
        _warmed = False


def on_compile(duration_s: float, what: str = "") -> None:
    """One device-program build of ``duration_s`` wall seconds: counted by
    phase, timed, ringed (``what``, "cuda_graph" or "nvcc", rides the
    event), and an anomaly when it lands after a completed warmup, as the
    JAX package's listener does for one XLA compile. Never raises into the
    capture or build it observes."""
    phase = compile_phase()
    try:
        from . import COMPILE_SECONDS, COMPILES, POST_WARMUP_COMPILES

        duration = float(duration_s)
        COMPILES.inc(phase=phase)
        COMPILE_SECONDS.observe(duration, phase=phase)
        if phase == "serving":
            POST_WARMUP_COMPILES.inc()
    except Exception:  # noqa: BLE001 - never break the capture or build
        return
    tag = {"what": what} if what else {}
    rec = get_recorder()
    rec.record("compile", phase=phase, duration_s=round(duration, 4), **tag)
    if phase == "serving":
        rec.anomaly("post_warmup_compile", duration_s=round(duration, 4), **tag)


def on_cache_event(event: str) -> None:
    """One kernel build cache event: "cache_hits" (the library of this
    source was already built) or "cache_misses" (nvcc ran)."""
    try:
        from . import COMPILE_CACHE_EVENTS

        COMPILE_CACHE_EVENTS.inc(event=event)
    except Exception:  # noqa: BLE001
        return
