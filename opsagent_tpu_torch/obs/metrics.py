"""Dependency-free Prometheus metrics core (the port's copy of
``opsagent_tpu/obs/metrics.py``).

Labeled counters, gauges, and fixed-bucket histograms with text-format
exposition (the ``text/plain; version=0.0.4`` wire format Prometheus
scrapes), mounted as ``GET /metrics`` on the serving API
(serving/api.py).

Design constraints:

- **No client library**: the container has no prometheus_client, so the
  registry implements the tiny slice of the exposition format the serving
  stack needs (counter / gauge / histogram, labels, HELP/TYPE headers,
  cumulative ``le`` buckets, label-value escaping).
- **Hot-path cheap**: ``Counter.inc`` / ``Histogram.observe`` are a dict
  lookup plus a float add under a per-metric lock — safe to call from the
  engine's dispatch loop, the scheduler thread, and HTTP handlers at once.
- **Idempotent registration**: ``registry.counter(name, ...)`` returns the
  existing instrument when the name is already registered (modules are
  imported in unpredictable orders across tests and entrypoints).
- **Collectors**: callables run at scrape time append extra exposition
  text — used to bridge the legacy PerfStats registry (utils/perf.py) so
  the host timers and ``/metrics`` stay consistent without dual
  instrumentation at every call site.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Any, Callable, Iterable

# Default latency buckets (seconds): from a millisecond to a cold
# multi-second prefill in one scheme.
DEFAULT_TIME_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

_METRIC_NAME_OK = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_:"
)


def escape_label_value(value: str) -> str:
    """Escape a label value per the exposition format: backslash, double
    quote, and newline must be escaped; everything else passes through."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace("\n", "\\n")
        .replace('"', '\\"')
    )


def _format_value(v: float) -> str:
    """Render a sample value: integers without a trailing .0 (Prometheus
    accepts both; the compact form diffs cleanly in golden tests)."""
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _label_str(names: tuple[str, ...], values: tuple[str, ...]) -> str:
    if not names:
        return ""
    inner = ",".join(
        f'{n}="{escape_label_value(v)}"' for n, v in zip(names, values)
    )
    return "{" + inner + "}"


class _Metric:
    """Base: one named instrument holding per-label-set children."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: tuple[str, ...]):
        if not name or not set(name) <= _METRIC_NAME_OK or name[0].isdigit():
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: dict[tuple[str, ...], Any] = {}

    def _key(self, labels: dict[str, str] | None) -> tuple[str, ...]:
        # The JAX package's set comparison, as a length check and lookups:
        # this runs a few dozen times a serving tick.
        labels = labels or {}
        if len(labels) == len(self.labelnames):
            try:
                return tuple([str(labels[n]) for n in self.labelnames])
            except KeyError:
                pass
        raise ValueError(
            f"{self.name}: expected labels {self.labelnames}, "
            f"got {tuple(labels)}"
        )

    def collect(self) -> list[str]:
        raise NotImplementedError


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        key = self._key(labels)
        with self._lock:
            self._children[key] = self._children.get(key, 0.0) + amount

    def value(self, **labels: str) -> float:
        with self._lock:
            return self._children.get(self._key(labels), 0.0)

    def collect(self) -> list[str]:
        with self._lock:
            items = sorted(self._children.items())
        return [
            f"{self.name}{_label_str(self.labelnames, k)} {_format_value(v)}"
            for k, v in items
        ]


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._children[key] = float(value)

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._children[key] = self._children.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels: str) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels: str) -> float:
        with self._lock:
            return self._children.get(self._key(labels), 0.0)

    def collect(self) -> list[str]:
        with self._lock:
            items = sorted(self._children.items())
        return [
            f"{self.name}{_label_str(self.labelnames, k)} {_format_value(v)}"
            for k, v in items
        ]


class Histogram(_Metric):
    """Fixed-bucket histogram: per-bucket counts are NON-cumulative in
    memory (one increment per observe) and summed cumulatively at collect
    time, so ``observe`` stays O(log buckets)."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str,
        labelnames: tuple[str, ...] = (),
        buckets: Iterable[float] = DEFAULT_TIME_BUCKETS,
    ):
        super().__init__(name, help, labelnames)
        bs = sorted(float(b) for b in buckets)
        if not bs:
            raise ValueError("histogram needs at least one bucket")
        self.buckets = tuple(bs)

    def observe(self, value: float, **labels: str) -> None:
        key = self._key(labels)
        idx = bisect_left(self.buckets, float(value))
        with self._lock:
            child = self._children.get(key)
            if child is None:
                # [per-bucket counts..., +Inf overflow], total count, sum
                child = [[0] * (len(self.buckets) + 1), 0, 0.0]
                self._children[key] = child
            child[0][idx] += 1
            child[1] += 1
            child[2] += float(value)

    def count(self, **labels: str) -> int:
        with self._lock:
            child = self._children.get(self._key(labels))
            return 0 if child is None else child[1]

    def sum(self, **labels: str) -> float:
        with self._lock:
            child = self._children.get(self._key(labels))
            return 0.0 if child is None else child[2]

    def collect(self) -> list[str]:
        with self._lock:
            items = sorted(
                (k, (list(v[0]), v[1], v[2]))
                for k, v in self._children.items()
            )
        out: list[str] = []
        for key, (counts, total, vsum) in items:
            cum = 0
            for b, c in zip(self.buckets, counts):
                cum += c
                names = self.labelnames + ("le",)
                vals = key + (_format_value(b),)
                out.append(
                    f"{self.name}_bucket{_label_str(names, vals)} {cum}"
                )
            names = self.labelnames + ("le",)
            out.append(
                f"{self.name}_bucket{_label_str(names, key + ('+Inf',))} "
                f"{total}"
            )
            out.append(
                f"{self.name}_sum{_label_str(self.labelnames, key)} "
                f"{_format_value(vsum)}"
            )
            out.append(
                f"{self.name}_count{_label_str(self.labelnames, key)} {total}"
            )
        return out


class Registry:
    """Named instruments + scrape-time collectors -> exposition text."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}
        self._collectors: list[Callable[[], list[str]]] = []

    def _get_or_make(self, cls, name: str, help: str, labelnames, **kw):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise ValueError(
                        f"{name} already registered as {existing.kind}"
                    )
                return existing
            m = cls(name, help, tuple(labelnames), **kw)
            self._metrics[name] = m
            return m

    def counter(
        self, name: str, help: str = "", labelnames: Iterable[str] = ()
    ) -> Counter:
        return self._get_or_make(Counter, name, help, labelnames)

    def gauge(
        self, name: str, help: str = "", labelnames: Iterable[str] = ()
    ) -> Gauge:
        return self._get_or_make(Gauge, name, help, labelnames)

    def histogram(
        self,
        name: str,
        help: str = "",
        labelnames: Iterable[str] = (),
        buckets: Iterable[float] = DEFAULT_TIME_BUCKETS,
    ) -> Histogram:
        return self._get_or_make(
            Histogram, name, help, labelnames, buckets=buckets
        )

    def add_collector(self, fn: Callable[[], list[str]]) -> None:
        """Register a scrape-time callable returning extra exposition
        lines (each a complete line, no trailing newline). Idempotent by
        identity."""
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def render(self) -> str:
        """The full exposition document (ends with a newline)."""
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
            collectors = list(self._collectors)
        lines: list[str] = []
        for m in metrics:
            samples = m.collect()
            if not samples:
                continue
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            lines.extend(samples)
        for fn in collectors:
            try:
                lines.extend(fn())
            except Exception:  # noqa: BLE001 - one bad collector must not
                continue       # take down the whole scrape
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict[str, Any]:
        """Compact machine-readable dump: counters/gauges as
        ``{name{labels}: value}``; histograms as count/sum pairs. Used by
        bench.py to fold the scrape into BENCH_*.json."""
        with self._lock:
            metrics = list(self._metrics.values())
        out: dict[str, Any] = {}
        for m in metrics:
            with m._lock:
                children = dict(m._children)
            for key, v in sorted(children.items()):
                tag = m.name + _label_str(m.labelnames, key)
                if isinstance(m, Histogram):
                    out[tag + "_count"] = v[1]
                    out[tag + "_sum"] = round(v[2], 6)
                else:
                    out[tag] = round(v, 6) if isinstance(v, float) else v
        return out

    def reset(self) -> None:
        """Drop every child sample (instruments and collectors stay
        registered). Test isolation hook."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            with m._lock:
                m._children.clear()


_default: Registry | None = None
_default_lock = threading.Lock()


def get_registry() -> Registry:
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                reg = Registry()
                _install_perf_bridge(reg)
                _default = reg
    return _default


def _install_perf_bridge(reg: Registry) -> None:
    """Bridge the PerfStats registry into the scrape: every named series
    appears as ``opsagent_perf{series=...,stat=...}`` gauges, so
    dashboards see the host-path timers next to the first-class engine
    instruments. The HELP line is the JAX package's, byte for byte."""

    def collect() -> list[str]:
        from ..utils.perf import get_perf_stats

        stats = get_perf_stats().get_stats()
        gauges = stats.pop("gauges", {})
        lines = [
            "# HELP opsagent_perf legacy PerfStats series "
            "(bridged; see /api/perf/stats)",
            "# TYPE opsagent_perf gauge",
        ]
        n = len(lines)
        for name in sorted(stats):
            s = stats[name]
            if not s.get("count"):
                continue
            for stat in ("count", "avg", "p50", "p95", "p99", "max"):
                if stat in s:
                    lines.append(
                        f'opsagent_perf{{series="{escape_label_value(name)}"'
                        f',stat="{stat}",unit="{escape_label_value(s.get("unit", ""))}"}}'
                        f" {_format_value(float(s[stat]))}"
                    )
        for name in sorted(gauges):
            lines.append(
                f'opsagent_perf{{series="{escape_label_value(name)}"'
                f',stat="gauge",unit=""}} {_format_value(float(gauges[name]))}'
            )
        return lines if len(lines) > n else []

    reg.add_collector(collect)
