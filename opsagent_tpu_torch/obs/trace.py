"""Per-request trace spans (the port's copy of
``opsagent_tpu/obs/trace.py``).

A request ID is minted at ingress (HTTP middleware, the chat-completions
frontend, or the ReAct loop when called directly) and the request's life is
recorded as a span tree: queue-wait -> prefill -> per-block decode ->
detokenize -> tool-exec. The tree is retrievable at
``GET /api/trace/{request_id}`` while the request runs and after it
finishes (bounded ring of recent traces), and each completed trace emits
one structured JSON log event.

Propagation works two ways, because the serving stack crosses threads:

- **contextvars** carry the current span within a thread of execution
  (the ReAct loop's tool calls, the frontend's detokenize step), so
  ``span("tool_exec")`` nests under whatever is active.
- **explicit handles** carry it across the scheduler/engine thread
  boundary: the frontend attaches the request's span to the scheduler
  ``Request``, the scheduler passes it into ``engine.begin_request``, and
  the engine records phase children on the ``Sequence``'s handle. The
  scheduler thread has no ambient context — a contextvar set in the HTTP
  thread would silently not propagate there.

Everything no-ops when no trace is active, so the engine's hot loop pays
one ``is None`` check per instrumented site for untraced traffic (bench,
tests, direct engine use).
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import random
import threading
import time
import uuid
from collections import OrderedDict
from typing import Any, Iterator

from ..utils.logger import get_logger

log = get_logger("obs.trace")

# -- tail-based retention -----------------------------------------------------
# At million-session volume a keep-everything ring is useless: the 512
# slots hold the last few seconds of HEALTHY traffic and the one request
# you want to investigate is long gone. Tail-based sampling inverts it:
# the retention decision happens at request FINISH, when we know whether
# anything went wrong. Anomalous requests (SLO breach, error, failover,
# engine restart) are always kept; healthy ones survive a probability-p
# draw (OPSAGENT_TRACE_SAMPLE, default 1.0 = keep all — the single-box
# dev default). opsagent_trace_retention_total{decision} proves the
# policy on the scrape.
_ENV_SAMPLE = "OPSAGENT_TRACE_SAMPLE"
_sample_p: float | None = None     # None = read the env on first use
# Request ids marked anomalous from OUTSIDE the trace's own thread (the
# router's failover path marks the journey id between legs; the resumed
# leg's fresh Trace under the same id must inherit the flag). Bounded:
# ids are unbounded, this set must not be.
_anomalous_ids: "OrderedDict[str, float]" = OrderedDict()
_anomalous_lock = threading.Lock()
_ANOMALOUS_CAP = 4096


def sample_probability() -> float:
    global _sample_p
    if _sample_p is None:
        try:
            _sample_p = min(
                1.0, max(0.0, float(os.environ.get(_ENV_SAMPLE, "1.0")))
            )
        except ValueError:
            _sample_p = 1.0
    return _sample_p


def set_sample_probability(p: float | None) -> None:
    """Programmatic override (bench/tests); None re-reads the env."""
    global _sample_p
    _sample_p = None if p is None else min(1.0, max(0.0, float(p)))


def mark_anomalous(request_id: str | None, reason: str = "") -> None:
    """Flag a request's trace as anomalous so tail-based retention always
    keeps it. Safe for unknown/absent ids; the flag also outlives the
    current trace object so a failover's resumed leg (a fresh Trace under
    the same journey id) inherits it."""
    if not request_id:
        return
    with _anomalous_lock:
        _anomalous_ids[request_id] = time.time()
        _anomalous_ids.move_to_end(request_id)
        while len(_anomalous_ids) > _ANOMALOUS_CAP:
            _anomalous_ids.popitem(last=False)
    t = _store.get(request_id)
    if t is not None:
        t.anomalous = True
        if reason:
            t.anomaly_reason = t.anomaly_reason or reason


def _is_marked(request_id: str) -> bool:
    with _anomalous_lock:
        return request_id in _anomalous_ids


def reset_retention() -> None:
    """Test-isolation hook: forget marks and the sampling override."""
    global _sample_p
    _sample_p = None
    with _anomalous_lock:
        _anomalous_ids.clear()


class Span:
    """One timed phase. ``t0``/``t1`` are ``time.perf_counter`` readings;
    ``t1`` is None while the span is open. Mutations lock on the owning
    trace so scheduler-thread and HTTP-thread children never race."""

    __slots__ = ("name", "t0", "t1", "attrs", "children", "trace")

    def __init__(self, name: str, trace: "Trace", t0: float | None = None):
        self.name = name
        self.trace = trace
        self.t0 = time.perf_counter() if t0 is None else t0
        self.t1: float | None = None
        self.attrs: dict[str, Any] = {}
        self.children: list[Span] = []

    # -- recording -----------------------------------------------------------
    def child(
        self, name: str, t0: float, t1: float, **attrs: Any
    ) -> "Span":
        """Attach an already-completed child span (engine-side phases are
        timed with plain floats and attached after the fact)."""
        s = Span(name, self.trace, t0=t0)
        s.t1 = t1
        s.attrs.update(attrs)
        with self.trace._lock:
            self.children.append(s)
        return s

    def start_child(self, name: str, **attrs: Any) -> "Span":
        s = Span(name, self.trace)
        s.attrs.update(attrs)
        with self.trace._lock:
            self.children.append(s)
        return s

    def close(self, **attrs: Any) -> None:
        with self.trace._lock:
            if self.t1 is None:
                self.t1 = time.perf_counter()
            self.attrs.update(attrs)

    def set(self, **attrs: Any) -> None:
        with self.trace._lock:
            self.attrs.update(attrs)

    # -- reading -------------------------------------------------------------
    def duration_s(self, now: float | None = None) -> float:
        end = self.t1 if self.t1 is not None else (now or time.perf_counter())
        return max(0.0, end - self.t0)

    def to_dict(self, origin: float) -> dict[str, Any]:
        with self.trace._lock:
            children = list(self.children)
            attrs = dict(self.attrs)
            t1 = self.t1
        d: dict[str, Any] = {
            "name": self.name,
            "start_ms": round((self.t0 - origin) * 1e3, 3),
            "duration_ms": round(self.duration_s() * 1e3, 3),
        }
        if t1 is None:
            d["open"] = True
        if attrs:
            d["attrs"] = attrs
        if children:
            d["children"] = [c.to_dict(origin) for c in children]
        return d


class Trace:
    """One request's span tree, rooted at the ingress span."""

    def __init__(self, request_id: str):
        self.request_id = request_id
        self._lock = threading.RLock()
        self.started_at = time.time()
        self.root = Span("request", self)
        self.finished = False
        # Tail-based retention state: anomalous traces are always kept;
        # slo_class is stamped at ingress and read by the engine/scheduler
        # observation sites through their span handle (span.trace).
        self.anomalous = _is_marked(request_id)
        self.anomaly_reason = ""
        self.slo_class = ""

    def finish(self, **attrs: Any) -> None:
        """Close the root, emit the structured JSON log event, and apply
        the tail-based retention policy (here rather than in
        ``trace_request`` so directly-managed traces — the OpenAI
        frontend owns its Trace without the context manager — get the
        same decision). Safe to call more than once (only the first
        closes/logs/decides)."""
        with self._lock:
            if self.finished:
                return
            self.finished = True
        self.root.close(**attrs)
        phases = self.phase_totals_ms()
        log.info(
            "trace %s done in %.1f ms",
            self.request_id,
            self.root.duration_s() * 1e3,
            extra={
                "fields": {
                    "event": "trace",
                    "request_id": self.request_id,
                    "duration_ms": round(self.root.duration_s() * 1e3, 3),
                    "phases_ms": phases,
                }
            },
        )
        _store.finalize(self)

    def phase_totals_ms(self) -> dict[str, float]:
        """Wall milliseconds per DIRECT child phase of the root, summed by
        name. Direct children partition the request (children of children
        may overlap — pipelined decode blocks — so only the top level is a
        meaningful sum)."""
        with self._lock:
            children = list(self.root.children)
        out: dict[str, float] = {}
        for c in children:
            out[c.name] = round(
                out.get(c.name, 0.0) + c.duration_s() * 1e3, 3
            )
        return out

    def to_dict(self) -> dict[str, Any]:
        d = {
            "request_id": self.request_id,
            "started_at": self.started_at,
            "finished": self.finished,
            "duration_ms": round(self.root.duration_s() * 1e3, 3),
            "phases_ms": self.phase_totals_ms(),
            "root": self.root.to_dict(self.root.t0),
        }
        if self.slo_class:
            d["slo_class"] = self.slo_class
        if self.anomalous:
            d["anomalous"] = True
            if self.anomaly_reason:
                d["anomaly_reason"] = self.anomaly_reason
        return d


class TraceStore:
    """Bounded ring of recent traces keyed by request ID. Traces register
    at START so in-flight requests are inspectable; eviction prefers the
    oldest HEALTHY trace so anomalous ones outlive healthy churn (an
    all-anomalous ring still evicts oldest-first — the bound is hard)."""

    def __init__(self, capacity: int = 512):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._traces: "OrderedDict[str, Trace]" = OrderedDict()

    def add(self, trace: Trace) -> None:
        with self._lock:
            self._traces[trace.request_id] = trace
            self._traces.move_to_end(trace.request_id)
            while len(self._traces) > self.capacity:
                victim = None
                for rid, t in self._traces.items():
                    if not t.anomalous:
                        victim = rid
                        break
                if victim is None:
                    self._traces.popitem(last=False)
                else:
                    self._traces.pop(victim, None)

    def get(self, request_id: str) -> Trace | None:
        with self._lock:
            return self._traces.get(request_id)

    def discard(self, request_id: str) -> None:
        with self._lock:
            self._traces.pop(request_id, None)

    def finalize(self, trace: Trace) -> str:
        """Apply the tail-based retention policy to a finished trace and
        return the decision. Anomalous (flagged on the trace or marked by
        id from another thread, e.g. the router's failover path) is always
        kept; healthy traces survive a probability-p draw."""
        if trace.anomalous or _is_marked(trace.request_id):
            trace.anomalous = True
            decision = "kept_anomalous"
        else:
            p = sample_probability()
            if p >= 1.0 or random.random() < p:
                decision = "kept_sampled"
            else:
                decision = "dropped"
                self.discard(trace.request_id)
        try:
            from . import TRACE_RETENTION

            TRACE_RETENTION.inc(decision=decision)
        except Exception:
            pass
        return decision

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()


_store = TraceStore()
_current: "contextvars.ContextVar[Span | None]" = contextvars.ContextVar(
    "opsagent_current_span", default=None
)


def get_store() -> TraceStore:
    return _store


def current_span() -> Span | None:
    return _current.get()


def new_request_id(prefix: str = "req") -> str:
    return f"{prefix}-{uuid.uuid4().hex[:24]}"


def get_trace(request_id: str) -> dict[str, Any] | None:
    t = _store.get(request_id)
    return None if t is None else t.to_dict()


def class_of(handle: Any, default: str = "") -> str:
    """SLO class of the trace behind a span/trace handle (engine and
    scheduler sites hold a Span; the ingress stamped slo_class on its
    Trace). Returns ``default`` for untraced traffic."""
    if handle is None:
        return default
    trace = getattr(handle, "trace", handle)
    return getattr(trace, "slo_class", "") or default


def current_class(default: str = "") -> str:
    """SLO class of the context's active trace (ReAct-loop side)."""
    return class_of(_current.get(), default)


@contextlib.contextmanager
def trace_request(request_id: str | None = None) -> Iterator[Trace]:
    """Root a new trace for one request and make its root span current
    for this thread of execution. Finishes (and logs) on exit."""
    t = Trace(request_id or new_request_id())
    _store.add(t)
    token = _current.set(t.root)
    try:
        yield t
    finally:
        _current.reset(token)
        t.finish()


def format_tree(trace_dict: dict[str, Any]) -> str:
    """Human-readable span tree (verbose CLI runs print this to stderr):

        request 812.4 ms  [req-ab12...]
          llm_turn 530.1 ms
            generate 528.9 ms
              queue_wait 1.2 ms
              prefill 102.3 ms
              decode 424.0 ms (tokens=37)
          tool_exec 281.0 ms (tool=kubectl)
    """
    lines = [
        f"trace {trace_dict.get('request_id', '?')} "
        f"{trace_dict.get('duration_ms', 0.0):.1f} ms"
    ]

    def walk(node: dict[str, Any], depth: int) -> None:
        attrs = node.get("attrs") or {}
        tag = ""
        if attrs:
            inner = ", ".join(f"{k}={v}" for k, v in sorted(attrs.items()))
            tag = f" ({inner})"
        lines.append(
            f"{'  ' * depth}{node.get('name', '?')} "
            f"{node.get('duration_ms', 0.0):.1f} ms{tag}"
        )
        for c in node.get("children", []):
            walk(c, depth + 1)

    root = trace_dict.get("root")
    if root:
        walk(root, 1)
    return "\n".join(lines)


@contextlib.contextmanager
def span(name: str, parent: Span | None = None, **attrs: Any) -> Iterator[Span | None]:
    """Open a child span under ``parent`` (or the context's current span)
    and make it current. Yields None (and records nothing) when no trace
    is active — instrumented code needs no feature flag."""
    p = parent if parent is not None else _current.get()
    if p is None:
        yield None
        return
    s = p.start_child(name, **attrs)
    token = _current.set(s)
    try:
        yield s
    finally:
        _current.reset(token)
        s.close()
