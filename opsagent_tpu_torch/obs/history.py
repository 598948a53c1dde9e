"""Telemetry time machine: an in-process, memory-bounded history of the
key metric families, with tiered downsampling (the port's copy of
``opsagent_tpu/obs/history.py``).

Every other observability surface in-tree is instantaneous — ``/metrics``
is a point-in-time scrape, ``/api/slo`` evaluates the current histograms,
the flight ring is a bounded event buffer. The questions operators
actually ask ("did goodput degrade by class during that burst?",
"per-class SLO attainment over the last hour") need the *time dimension*,
which normally means an external Prometheus nobody runs in CI. This
module keeps a small, dependency-free slice of it resident:

- A background sampler (or an explicit ``sample(now)`` call — tests walk
  a synthetic clock) snapshots selected series once per second.
- **Tiered downsampling**: 1 s resolution for the last 5 minutes, 10 s
  for the last hour, 60 s beyond — older points are merged, never
  silently dropped, until the byte bound evicts the oldest 60 s points.
- **Counters are stored as deltas** (the increment over each point's
  interval), so rates are exact at every tier: a 10 s point's delta is
  the sum of the ten 1 s deltas it replaced, and ``delta / step`` is the
  true mean rate of that interval. Gauges downsample by mean.
- Served as ``GET /api/metrics/history?series=&since=&step=`` on both
  servers, and fleet-aggregated (skew-corrected via the heartbeat
  ClockSync offsets) on the router.

Timestamps are wall-clock (``time.time()``) so the router can apply the
same ``wall - offset`` correction the fleet flight ledger and timeline
stitcher already use for cross-replica ordering.
"""

from __future__ import annotations

import math
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

from ..utils.logger import get_logger

log = get_logger("obs.history")

_ENV_BYTES = "OPSAGENT_HISTORY_BYTES"
_ENV_INTERVAL = "OPSAGENT_HISTORY_INTERVAL_S"

# (step_seconds, horizon_seconds): points older than a tier's horizon are
# rolled up into the next tier. The last tier has no horizon — it is
# bounded by DEFAULT_MAX_BYTES instead (oldest points evicted).
TIER_SPECS: tuple[tuple[float, float | None], ...] = (
    (1.0, 300.0),
    (10.0, 3600.0),
    (60.0, None),
)
DEFAULT_MAX_BYTES = 2 * 1024 * 1024
DEFAULT_INTERVAL_S = 1.0
# Conservative resident-size estimate of one [ts, value] point (two
# floats + list + deque slot overhead) — the byte bound is a budget, not
# an accounting exercise.
POINT_BYTES = 120


def _env_float(name: str, default: float) -> float:
    try:
        v = float(os.environ.get(name, "") or default)
        return v if v > 0 else default
    except ValueError:
        return default


@dataclass
class _Series:
    name: str
    kind: str                      # "counter" (stored as deltas) | "gauge"
    fn: Callable[[], float | None]
    # One deque of [ts, value] per tier, oldest first. ts is the END of
    # the point's interval.
    tiers: list[deque] = field(default_factory=list)
    last_raw: float | None = None  # counters: previous cumulative value

    def __post_init__(self) -> None:
        if self.kind not in ("counter", "gauge"):
            raise ValueError(f"series kind {self.kind!r}")
        self.tiers = [deque() for _ in TIER_SPECS]


class TelemetryHistory:
    """Memory-bounded multi-series history ring with tiered downsampling.

    Thread-safe; ``sample``/``query`` take explicit ``now`` values so
    tests can walk a synthetic 90-minute clock without sleeping.
    """

    def __init__(
        self,
        max_bytes: int | None = None,
        interval_s: float | None = None,
    ):
        self.max_bytes = int(
            max_bytes if max_bytes is not None
            else _env_float(_ENV_BYTES, DEFAULT_MAX_BYTES)
        )
        self.interval_s = float(
            interval_s if interval_s is not None
            else _env_float(_ENV_INTERVAL, DEFAULT_INTERVAL_S)
        )
        self._lock = threading.Lock()
        self._series: dict[str, _Series] = {}
        self._samples = 0
        self._evicted = 0
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    # -- registration ------------------------------------------------------
    def register(
        self, name: str, kind: str, fn: Callable[[], float | None]
    ) -> None:
        """Idempotent: re-registering a name keeps the existing ring (the
        reader callable is refreshed — modules reload across tests)."""
        with self._lock:
            s = self._series.get(name)
            if s is not None:
                s.fn = fn
                s.kind = kind
                return
            self._series[name] = _Series(name=name, kind=kind, fn=fn)

    def series_names(self) -> list[str]:
        with self._lock:
            return sorted(self._series)

    # -- sampling ----------------------------------------------------------
    def sample(self, now: float | None = None) -> None:
        """Take one sweep: read every series, append tier-0 points, roll
        tiers, enforce the byte bound. Reader failures skip the series —
        history must never add a failure mode to what it observes."""
        if now is None:
            now = time.time()
        readings: list[tuple[_Series, float]] = []
        with self._lock:
            series = list(self._series.values())
        for s in series:
            try:
                raw = s.fn()
            except Exception:  # noqa: BLE001
                continue
            if raw is None:
                continue
            readings.append((s, float(raw)))
        with self._lock:
            for s, raw in readings:
                if s.kind == "counter":
                    prev, s.last_raw = s.last_raw, raw
                    if prev is None:
                        continue  # first sweep: no interval to delta over
                    s.tiers[0].append([now, max(0.0, raw - prev)])
                else:
                    s.tiers[0].append([now, raw])
            self._samples += 1
            self._rollup(now)
            self._enforce_bytes()
        self._export_gauges()

    def _rollup(self, now: float) -> None:
        """Promote points past each tier's horizon into the next tier,
        aligned to the coarser step. Counters sum their deltas (rates
        stay exact); gauges average. Caller holds the lock."""
        for s in self._series.values():
            for i in range(len(TIER_SPECS) - 1):
                _, horizon = TIER_SPECS[i]
                coarse_step = TIER_SPECS[i + 1][0]
                dq = s.tiers[i]
                while dq and now - dq[0][0] > horizon:
                    bucket = math.floor(dq[0][0] / coarse_step)
                    pts = []
                    while dq and math.floor(
                        dq[0][0] / coarse_step
                    ) == bucket:
                        pts.append(dq.popleft())
                    ts = pts[-1][0]
                    if s.kind == "counter":
                        v = sum(p[1] for p in pts)
                    else:
                        v = sum(p[1] for p in pts) / len(pts)
                    s.tiers[i + 1].append([ts, v])

    def _enforce_bytes(self) -> None:
        """Evict the oldest coarsest points while over budget. Caller
        holds the lock."""
        while self._bytes_locked() > self.max_bytes:
            oldest: _Series | None = None
            oldest_ts = math.inf
            for s in self._series.values():
                dq = s.tiers[-1]
                if dq and dq[0][0] < oldest_ts:
                    oldest_ts = dq[0][0]
                    oldest = s
            if oldest is None:
                # Nothing left in the coarse tier: evict from the next
                # finer tier that has points (a pathological byte bound).
                for tier in range(len(TIER_SPECS) - 2, -1, -1):
                    cands = [
                        s for s in self._series.values() if s.tiers[tier]
                    ]
                    if cands:
                        oldest = min(
                            cands, key=lambda s: s.tiers[tier][0][0]
                        )
                        oldest.tiers[tier].popleft()
                        self._evicted += 1
                        break
                else:
                    return
                continue
            oldest.tiers[-1].popleft()
            self._evicted += 1

    def _bytes_locked(self) -> int:
        n = sum(
            len(dq) for s in self._series.values() for dq in s.tiers
        )
        return n * POINT_BYTES

    def _export_gauges(self) -> None:
        try:
            from . import HISTORY_BYTES, HISTORY_POINTS, HISTORY_SAMPLES

            HISTORY_SAMPLES.inc()
            with self._lock:
                for i, (step, _) in enumerate(TIER_SPECS):
                    HISTORY_POINTS.set(
                        sum(
                            len(s.tiers[i])
                            for s in self._series.values()
                        ),
                        tier=f"{int(step)}s",
                    )
                HISTORY_BYTES.set(self._bytes_locked())
        except Exception:  # noqa: BLE001
            pass

    # -- querying ----------------------------------------------------------
    def query(
        self,
        series: list[str] | None = None,
        since: float = 300.0,
        step: float | None = None,
        now: float | None = None,
    ) -> dict[str, Any]:
        """Points for ``series`` (all when empty) newer than ``now -
        since``, merged across tiers oldest-first. With ``step``, points
        are re-bucketed to that resolution (counters sum deltas, gauges
        average) — asking for a coarser step than the native tier is
        exact for counters by construction."""
        if now is None:
            now = time.time()
        cutoff = now - max(0.0, since)
        out: dict[str, Any] = {}
        with self._lock:
            wanted = (
                [n for n in series if n in self._series]
                if series else sorted(self._series)
            )
            for name in wanted:
                s = self._series[name]
                pts = [
                    [p[0], p[1]]
                    for dq in reversed(s.tiers)
                    for p in dq
                    if p[0] >= cutoff
                ]
                pts.sort(key=lambda p: p[0])
                if step and step > 0:
                    pts = _rebucket(pts, step, s.kind)
                out[name] = {"kind": s.kind, "points": pts}
        return {
            "now": now,
            "since": since,
            "step": step,
            "tiers": [
                {"step_s": t[0], "horizon_s": t[1]} for t in TIER_SPECS
            ],
            "series": out,
        }

    def rate(
        self,
        name: str,
        window_s: float = 60.0,
        now: float | None = None,
        min_points: int = 2,
    ) -> float | None:
        """Mean per-second rate of a counter series over the trailing
        window: summed deltas over the covered span. None when fewer than
        ``min_points`` points cover the window (no fake rates from one
        sweep)."""
        if now is None:
            now = time.time()
        with self._lock:
            s = self._series.get(name)
            if s is None or s.kind != "counter":
                return None
            cutoff = now - window_s
            pts = [
                p for dq in s.tiers for p in dq if p[0] >= cutoff
            ]
        if len(pts) < min_points:
            return None
        pts.sort(key=lambda p: p[0])
        span = pts[-1][0] - pts[0][0]
        if span <= 0:
            return None
        # The first point's delta covers the interval BEFORE its
        # timestamp; drop it so the numerator matches the span.
        total = sum(p[1] for p in pts[1:])
        return max(0.0, total) / span

    def window_sum(
        self, name: str, window_s: float = 60.0, now: float | None = None
    ) -> float:
        """Summed counter deltas over the trailing window (0.0 when the
        series is unknown or empty)."""
        if now is None:
            now = time.time()
        with self._lock:
            s = self._series.get(name)
            if s is None:
                return 0.0
            cutoff = now - window_s
            return sum(
                p[1] for dq in s.tiers for p in dq if p[0] >= cutoff
            )

    def stats(self) -> dict[str, Any]:
        with self._lock:
            return {
                "series": len(self._series),
                "samples": self._samples,
                "evicted": self._evicted,
                "bytes": self._bytes_locked(),
                "max_bytes": self.max_bytes,
                "points_per_tier": [
                    sum(
                        len(s.tiers[i]) for s in self._series.values()
                    )
                    for i in range(len(TIER_SPECS))
                ],
                "running": self._thread is not None,
            }

    # -- background sampler ------------------------------------------------
    def start(self) -> None:
        """Idempotent background 1 Hz sampler (servers call this beside
        the SLO watchdog's start)."""
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="telemetry-history"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample()
            except Exception:  # noqa: BLE001 - sampler must survive
                log.exception("history sample failed")

    def reset(self) -> None:
        """Test-isolation hook: drop every point and counter baseline
        (registered series and the running sampler survive)."""
        with self._lock:
            for s in self._series.values():
                for dq in s.tiers:
                    dq.clear()
                s.last_raw = None
            self._samples = 0
            self._evicted = 0


def _rebucket(
    pts: list[list[float]], step: float, kind: str
) -> list[list[float]]:
    """Re-bucket sorted [ts, value] points to ``step`` resolution: one
    point per occupied bucket, stamped at the bucket's end."""
    out: list[list[float]] = []
    acc: list[float] = []
    bucket: float | None = None
    for ts, v in pts:
        b = math.floor(ts / step)
        if bucket is not None and b != bucket:
            out.append(_close_bucket(bucket, step, acc, kind))
            acc = []
        bucket = b
        acc.append(v)
    if bucket is not None and acc:
        out.append(_close_bucket(bucket, step, acc, kind))
    return out


def _close_bucket(
    bucket: float, step: float, acc: list[float], kind: str
) -> list[float]:
    v = sum(acc) if kind == "counter" else sum(acc) / len(acc)
    return [(bucket + 1) * step, v]


# -- default series -----------------------------------------------------------
def _counter_total(c: Any) -> float:
    """Sum of every child of a labeled counter (the all-labels total)."""
    with c._lock:
        return float(sum(c._children.values()))


def _hist_quantile_ms(hist: Any, q: float, **labels: str):
    from . import slo

    v = slo.histogram_quantile(hist, q, **labels)
    return None if v is None else v * 1e3


def install_default_series(h: TelemetryHistory) -> None:
    """Register the selected families the tentpole names: goodput split,
    TTFT/ITL quantiles, occupancy/queue gauges, shed/failover/hedge
    rates, attribution MFU/HBM-util/drift, pagestore hits, per-class
    traffic. Idempotent."""
    import functools

    from . import (
        ANOMALIES,
        BATCH_OCCUPANCY,
        CLASS_ITL_SECONDS,
        CLASS_REQUESTS,
        CLASS_TTFT_SECONDS,
        DECODE_TOKENS,
        ENGINE_REQUESTS,
        FANOUT_ACTIVE,
        FANOUT_CHILDREN,
        FANOUT_CHILDREN_DONE,
        FANOUT_CHILDREN_TOTAL,
        FANOUT_PREFIX_HIT_RATE,
        FLEET_FAILOVERS,
        FLEET_HEDGES,
        FLEET_RETRIES,
        FLEET_SHED,
        ITL_SECONDS,
        KV_PAGE_UTILIZATION,
        PAGESTORE_LOOKUPS,
        PAGESTORE_REMOTE_HITS,
        RUNNING_SEQUENCES,
        SLO_CLASSES,
        TTFT_SECONDS,
        attribution,
    )

    for phase in ("queued", "prefill", "decode_active", "tool_blocked"):
        h.register(
            f"goodput.{phase}", "counter",
            functools.partial(
                attribution.GOODPUT_SECONDS.value, phase=phase
            ),
        )
    h.register("decode_tokens", "counter", DECODE_TOKENS.value)
    h.register(
        "requests.completed", "counter",
        functools.partial(ENGINE_REQUESTS.value, outcome="completed"),
    )
    h.register(
        "requests.bad", "counter",
        lambda: sum(
            ENGINE_REQUESTS.value(outcome=o)
            for o in ("error", "timeout", "admission_failed")
        ),
    )
    h.register(
        "fleet.shed", "counter", functools.partial(_counter_total, FLEET_SHED)
    )
    h.register("fleet.failovers", "counter", FLEET_FAILOVERS.value)
    h.register("fleet.retries", "counter", FLEET_RETRIES.value)
    h.register(
        "fleet.hedges", "counter",
        functools.partial(_counter_total, FLEET_HEDGES),
    )
    h.register("pagestore.lookups", "counter", PAGESTORE_LOOKUPS.value)
    h.register(
        "pagestore.remote_hits", "counter", PAGESTORE_REMOTE_HITS.value
    )
    h.register(
        "anomalies", "counter", functools.partial(_counter_total, ANOMALIES)
    )
    h.register(
        "ttft_p50_ms", "gauge",
        functools.partial(_hist_quantile_ms, TTFT_SECONDS, 0.5),
    )
    h.register(
        "ttft_p95_ms", "gauge",
        functools.partial(_hist_quantile_ms, TTFT_SECONDS, 0.95),
    )
    h.register(
        "itl_p50_ms", "gauge",
        functools.partial(_hist_quantile_ms, ITL_SECONDS, 0.5),
    )
    h.register(
        "itl_p95_ms", "gauge",
        functools.partial(_hist_quantile_ms, ITL_SECONDS, 0.95),
    )
    h.register("kv_page_utilization", "gauge", KV_PAGE_UTILIZATION.value)
    h.register("batch_occupancy", "gauge", BATCH_OCCUPANCY.value)
    h.register("running_sequences", "gauge", RUNNING_SEQUENCES.value)
    h.register("attr.mfu", "gauge", attribution.ATTR_MFU.value)
    h.register(
        "attr.hbm_utilization", "gauge", attribution.ATTR_HBM_UTIL.value
    )
    h.register("attr.drift", "gauge", attribution.ATTR_MODEL_DRIFT.value)
    for cls in SLO_CLASSES:
        h.register(
            f"class.{cls}.completed", "counter",
            functools.partial(
                CLASS_REQUESTS.value,
                **{"class": cls, "outcome": "completed"},
            ),
        )
        h.register(
            f"class.{cls}.bad", "counter",
            functools.partial(_class_bad, CLASS_REQUESTS, cls),
        )
        h.register(
            f"class.{cls}.ttft_p95_ms", "gauge",
            functools.partial(
                _hist_quantile_ms, CLASS_TTFT_SECONDS, 0.95,
                **{"class": cls},
            ),
        )
        h.register(
            f"class.{cls}.itl_p95_ms", "gauge",
            functools.partial(
                _hist_quantile_ms, CLASS_ITL_SECONDS, 0.95,
                **{"class": cls},
            ),
        )

    # Audit fan-out cockpit row (opsagent top): active fan-outs, children
    # done/planned of the newest one, its shared-prefix hit rate, and the
    # all-outcome child completion rate.
    h.register("fanout.active", "gauge", FANOUT_ACTIVE.value)
    h.register(
        "fanout.children_planned", "gauge", FANOUT_CHILDREN_TOTAL.value
    )
    h.register("fanout.children_done", "gauge", FANOUT_CHILDREN_DONE.value)
    h.register(
        "fanout.prefix_hit_rate", "gauge", FANOUT_PREFIX_HIT_RATE.value
    )
    h.register(
        "fanout.children", "counter",
        functools.partial(_counter_total, FANOUT_CHILDREN),
    )


def _class_bad(counter: Any, cls: str) -> float:
    return sum(
        counter.value(**{"class": cls, "outcome": o})
        for o in ("error", "timeout", "admission_failed", "shed")
    )


_history: TelemetryHistory | None = None
_history_lock = threading.Lock()


def get_history() -> TelemetryHistory:
    """The process-wide store, with the default series installed."""
    global _history
    if _history is None:
        with _history_lock:
            if _history is None:
                h = TelemetryHistory()
                install_default_series(h)
                _history = h
    return _history


def query(**kwargs: Any) -> dict[str, Any]:
    """Module-level convenience onto the process-wide store."""
    return get_history().query(**kwargs)


def parse_query(q: Any) -> dict[str, Any]:
    """``?series=&since=&step=`` URL-query strings -> ``query()`` kwargs
    (shared by both servers and the router so the grammar cannot drift).
    ``series`` is comma-separated; raises ValueError on malformed
    numbers."""
    kwargs: dict[str, Any] = {}
    series = (q.get("series") or "").strip()
    if series:
        kwargs["series"] = [s.strip() for s in series.split(",") if s.strip()]
    if q.get("since"):
        kwargs["since"] = float(q["since"])
    if q.get("step"):
        kwargs["step"] = float(q["step"])
    return kwargs


def reset() -> None:
    """Test-isolation hook: clear the singleton's points (no-op when the
    store was never created)."""
    if _history is not None:
        _history.reset()
