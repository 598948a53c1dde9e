"""Performance statistics registry (the port's copy of
``opsagent_tpu/utils/perf.py``).

Named timers and metrics with min/max/avg/p95/p99 aggregation. The serving
engine records its host-side timers here (``engine.warmup``,
``engine.mixed_dispatch``, ``engine.block_dispatch``, ``device.<name>``
under ``OPSAGENT_DEVICE_TIMING``); the registry is bridged into the
``/metrics`` exposition as ``opsagent_perf{series,stat}`` (obs/metrics.py),
so ``/metrics`` and these timers tell one story.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Callable, Iterator

# Per-series sample window. Sustained traffic used to grow every series
# without bound (the old list held every observation forever — at ~1 kB/s
# of floats per busy series that is an OOM on a long-lived server); the
# window bounds memory while count/avg/min/max stay exact via running
# aggregates. Percentiles are computed over the window, i.e. they are
# RECENT percentiles — the more useful flavor for a serving dashboard
# anyway (a p99 dominated by hour-old warmup samples is noise).
SERIES_WINDOW = 4096


class _Series:
    __slots__ = ("values", "unit", "count", "total", "vmin", "vmax")

    def __init__(self, unit: str = "ms", window: int = SERIES_WINDOW) -> None:
        self.values: deque[float] = deque(maxlen=window)
        self.unit = unit
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")

    def add(self, value: float) -> None:
        self.values.append(value)
        self.count += 1
        self.total += value
        if value < self.vmin:
            self.vmin = value
        if value > self.vmax:
            self.vmax = value

    def summary(self) -> dict[str, Any]:
        if self.count == 0:
            return {"count": 0, "unit": self.unit}
        vs = sorted(self.values)
        n = len(vs)

        def pct(p: float) -> float:
            idx = min(n - 1, max(0, int(round(p * (n - 1)))))
            return vs[idx]

        return {
            "count": self.count,
            "unit": self.unit,
            "min": self.vmin,
            "max": self.vmax,
            "avg": self.total / self.count,
            "p50": pct(0.50),
            "p95": pct(0.95),
            "p99": pct(0.99),
        }


class PerfStats:
    """Thread-safe registry of named timers, metrics and gauges."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._series: dict[str, _Series] = {}
        self._gauges: dict[str, float] = {}
        # name -> stack of start times: overlapping same-name timers from
        # concurrent requests pair LIFO instead of clobbering a single slot.
        self._active: dict[str, list[float]] = {}
        self.enabled = True

    # -- timers ------------------------------------------------------------
    # One recording path for every timer flavor: start/stop pairs, the
    # ``timer`` context manager, and ``trace_func`` all end in
    # ``record_metric(name, elapsed_ms, "ms")``, so the aggregation,
    # enable gating, and units cannot drift between entry points.
    def start_timer(self, name: str) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._active.setdefault(name, []).append(time.perf_counter())

    def stop_timer(self, name: str) -> float:
        if not self.enabled:
            return 0.0
        now = time.perf_counter()
        with self._lock:
            stack = self._active.get(name)
            if not stack:
                return 0.0
            t0 = stack.pop()
        ms = (now - t0) * 1e3
        self.record_metric(name, ms, "ms")
        return ms

    @contextmanager
    def timer(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record_metric(name, (time.perf_counter() - t0) * 1e3, "ms")

    # -- metrics / gauges --------------------------------------------------
    def record_metric(self, name: str, value: float, unit: str = "") -> None:
        if not self.enabled:
            return
        with self._lock:
            series = self._series.get(name)
            if series is None:
                series = self._series[name] = _Series(unit)
            series.add(value)

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    # -- accessors ---------------------------------------------------------
    def get_stats(self) -> dict[str, Any]:
        with self._lock:
            out: dict[str, Any] = {
                name: s.summary() for name, s in self._series.items()
            }
            if self._gauges:
                out["gauges"] = dict(self._gauges)
            return out

    def reset(self) -> None:
        """Clear aggregated series and gauges. In-flight ``start_timer``
        stacks are deliberately KEPT: a reset landing mid-request used to
        orphan the open timer (its ``stop_timer`` found an empty stack and
        silently recorded nothing); now the pair still completes and lands
        in the post-reset window."""
        with self._lock:
            self._series.clear()
            self._gauges.clear()

    def format_table(self) -> str:
        stats = self.get_stats()
        gauges = stats.pop("gauges", {})
        lines = [
            f"{'operation':<44} {'count':>6} {'avg':>9} {'p95':>9} {'p99':>9} {'max':>9} unit"
        ]
        for name in sorted(stats):
            s = stats[name]
            if s.get("count", 0) == 0:
                continue
            lines.append(
                f"{name:<44} {s['count']:>6} {s['avg']:>9.2f} {s['p95']:>9.2f} "
                f"{s['p99']:>9.2f} {s['max']:>9.2f} {s['unit']}"
            )
        for name in sorted(gauges):
            lines.append(f"{name:<44} {'gauge':>6} {gauges[name]:>9.2f}")
        return "\n".join(lines)


_singleton: PerfStats | None = None
_singleton_lock = threading.Lock()


def get_perf_stats() -> PerfStats:
    global _singleton
    if _singleton is None:
        with _singleton_lock:
            if _singleton is None:
                _singleton = PerfStats()
    return _singleton


def trace_func(name: str) -> Callable[[], None]:
    """Start a timer and return the stopper; mirrors ``defer TraceFunc()()``
    instrumentation style (reference pkg/utils/perf.go:288-293). The start
    time lives in the closure, so concurrent traces of the same name are
    each timed correctly."""
    ps = get_perf_stats()
    t0 = time.perf_counter()

    def stop() -> None:
        ps.record_metric(name, (time.perf_counter() - t0) * 1e3, "ms")

    return stop
