"""SLO watchdog: declared serving objectives evaluated live from the
serving histograms (the port's copy of ``opsagent_tpu/obs/slo.py``; the
chip count is the number of CUDA devices).

The north-star metrics (BASELINE.json: p50 TTFT per agent tool-call turn
< 500 ms; >= 2000 tok/s/chip decode) are otherwise computed OFFLINE after
a run — the server itself would not know whether it was meeting them. The
watchdog closes that loop: the same histograms the engine records (``opsagent_ttft_seconds``,
``opsagent_inter_token_latency_seconds``, ``opsagent_engine_requests_total``,
``opsagent_decode_tokens_total``) are folded into declared SLOs with
pass/fail and a burn rate, exposed three ways:

- ``GET /api/slo`` on the serving API — JSON verdicts;
- ``opsagent_slo_*`` gauges on ``/metrics`` (a scrape-time collector, so
  dashboards can alert on ``opsagent_slo_pass == 0``);

Quantiles are estimated from the cumulative histogram buckets with the
standard Prometheus ``histogram_quantile`` linear interpolation — the
estimate and the raw count/sum ride the verdict so a reader can check the
arithmetic against the same ``/metrics`` samples.

Burn rate follows the SRE convention "how fast is the budget burning":
``observed / target`` for lower-is-better objectives (latency, error
rate) and ``target / observed`` for higher-is-better ones (throughput),
so burn > 1.0 always means "violating" and 2.0 means "twice as bad as
allowed".

Targets are env-tunable (defaults in parentheses):

- ``OPSAGENT_SLO_TTFT_MS``   — p50 TTFT (500; also the flight recorder's
  per-request anomaly threshold, so the alarm line and the SLO agree)
- ``OPSAGENT_SLO_ITL_MS``    — p50 inter-token latency (100)
- ``OPSAGENT_SLO_ERROR_RATE``— failed / total engine requests (0.01)
- ``OPSAGENT_SLO_TOK_S_CHIP``— decode tokens/sec/chip (0 = disabled;
  meaningless on a CPU test box)

Throughput needs a *rate*, which a counter alone cannot give: the
watchdog keeps a short ring of (time, counter) snapshots, refreshed by a
background thread on servers (``SLOWatchdog.start``) or implicitly by
each ``evaluate()`` call, and rates over the most recent window. Before
two snapshots >= 1 s apart exist the throughput SLO reports
``"insufficient data"`` instead of a fake pass.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import Any

from ..utils.logger import get_logger

log = get_logger("obs.slo")

_ENV_TTFT = "OPSAGENT_SLO_TTFT_MS"
_ENV_ITL = "OPSAGENT_SLO_ITL_MS"
_ENV_ERR = "OPSAGENT_SLO_ERROR_RATE"
_ENV_TOKS = "OPSAGENT_SLO_TOK_S_CHIP"

_RATE_WINDOW_S = 60.0
_MAX_SNAPSHOTS = 64


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


# -- SLO classes -------------------------------------------------------------
# Every request lands in exactly one class; the label is enum-only (the
# metrics-conformance cardinality guard rejects anything else). Explicit
# ``slo_class`` in the request body wins; otherwise the scenario decides
# (a human is waiting on a diagnosis; an audit sweep is throughput work).
_SCENARIO_CLASSES = {
    "diagnose": "interactive",
    "analyze": "interactive",
    "execute": "interactive",
    "audit": "batch",
}


def classify(
    body: Any = None, scenario: str = "", default: str = "interactive"
) -> str:
    """SLO class for one request: ``interactive`` | ``batch`` |
    ``background``. ``body`` may be the request dict (its ``slo_class``
    field wins when valid; its ``scenario`` field feeds the fallback)."""
    from . import SLO_CLASSES

    if isinstance(body, dict):
        explicit = str(body.get("slo_class") or "").strip().lower()
        if explicit in SLO_CLASSES:
            return explicit
        scenario = scenario or str(body.get("scenario") or "")
    mapped = _SCENARIO_CLASSES.get(scenario.strip().lower())
    if mapped:
        return mapped
    return default if default in SLO_CLASSES else "interactive"


@dataclass(frozen=True)
class SLO:
    name: str
    description: str
    target: float
    unit: str
    # "lt": observed must stay BELOW target; "gt": ABOVE target.
    direction: str = "lt"


def declared_slos() -> list[SLO]:
    slos = [
        SLO(
            "ttft_p50_ms",
            "p50 time-to-first-token per engine request "
            "(opsagent_ttft_seconds)",
            _env_float(_ENV_TTFT, 500.0),
            "ms",
        ),
        SLO(
            "itl_p50_ms",
            "p50 inter-token latency "
            "(opsagent_inter_token_latency_seconds)",
            _env_float(_ENV_ITL, 100.0),
            "ms",
        ),
        SLO(
            "error_rate",
            "failed / total engine requests "
            "(opsagent_engine_requests_total)",
            _env_float(_ENV_ERR, 0.01),
            "ratio",
        ),
    ]
    toks = _env_float(_ENV_TOKS, 0.0)
    if toks > 0:
        slos.append(
            SLO(
                "decode_tok_s_chip",
                "decode tokens/sec/chip over the recent window "
                "(opsagent_decode_tokens_total)",
                toks,
                "tok/s/chip",
                direction="gt",
            )
        )
    return slos


def histogram_quantile(hist: Any, q: float, **labels: str) -> float | None:
    """Prometheus-style quantile estimate from an obs.metrics.Histogram's
    cumulative buckets (linear interpolation within the bucket holding
    the quantile rank; the +Inf bucket clamps to the largest finite
    bound). None when the histogram has no samples."""
    with hist._lock:
        child = hist._children.get(hist._key(labels or None))
        if child is None:
            return None
        counts, total, _ = list(child[0]), child[1], child[2]
    if total <= 0:
        return None
    rank = q * total
    cum = 0.0
    lo = 0.0
    for i, b in enumerate(hist.buckets):
        c = counts[i]
        if cum + c >= rank:
            if c == 0:
                return b
            return lo + (b - lo) * (rank - cum) / c
        cum += c
        lo = b
    # Rank falls in the +Inf overflow bucket: clamp to the largest finite
    # bound (the Prometheus convention — nothing to interpolate toward).
    return hist.buckets[-1]


class SLOWatchdog:
    """Continuous SLO evaluation over the process-wide obs registry."""

    def __init__(self, interval_s: float = 5.0):
        self.interval_s = interval_s
        self._lock = threading.Lock()
        # (perf_counter, decode_tokens_total) snapshots, oldest first.
        self._snaps: list[tuple[float, float]] = []
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._last: list[dict[str, Any]] = []
        self._breached_since: dict[str, float] = {}
        self.take_snapshot()

    # -- rate bookkeeping --------------------------------------------------
    def take_snapshot(self) -> None:
        from . import DECODE_TOKENS

        now = time.perf_counter()
        with self._lock:
            self._snaps.append((now, DECODE_TOKENS.value()))
            # Keep the window bounded; retain at least two points.
            while len(self._snaps) > _MAX_SNAPSHOTS or (
                len(self._snaps) > 2
                and now - self._snaps[1][0] > _RATE_WINDOW_S
            ):
                self._snaps.pop(0)

    def _decode_rate(self) -> float | None:
        """tokens/sec over the most recent window. Rides TelemetryHistory
        when its sampler has points (servers run it at 1 Hz, so the rate
        is live ~2 s after boot instead of "UNKNOWN until two ad-hoc
        snapshots >= 1 s apart"); falls back to the watchdog's own
        snapshot pair when the sampler is off (bare evaluate() calls)."""
        from . import history as _history

        r = _history.get_history().rate("decode_tokens", _RATE_WINDOW_S)
        if r is not None:
            return r
        with self._lock:
            snaps = list(self._snaps)
        if len(snaps) < 2:
            return None
        (t0, c0), (t1, c1) = snaps[0], snaps[-1]
        if t1 - t0 < 1.0:
            return None
        return max(0.0, c1 - c0) / (t1 - t0)

    # -- evaluation --------------------------------------------------------
    def evaluate(self) -> dict[str, Any]:
        """All declared SLOs -> verdicts. Each verdict carries the
        observed value, the raw histogram count/sum it came from, pass
        (True/False, or None when there is no data yet), and burn_rate
        (> 1.0 = violating)."""
        from . import ENGINE_REQUESTS, ITL_SECONDS, TTFT_SECONDS

        self.take_snapshot()
        out: list[dict[str, Any]] = []
        for slo in declared_slos():
            v: dict[str, Any] = {
                "name": slo.name,
                "description": slo.description,
                "target": slo.target,
                "unit": slo.unit,
                "direction": slo.direction,
            }
            if slo.name == "ttft_p50_ms":
                p50 = histogram_quantile(TTFT_SECONDS, 0.5)
                v["count"] = TTFT_SECONDS.count()
                v["sum"] = round(TTFT_SECONDS.sum(), 6)
                v["value"] = None if p50 is None else round(p50 * 1e3, 3)
            elif slo.name == "itl_p50_ms":
                p50 = histogram_quantile(ITL_SECONDS, 0.5)
                v["count"] = ITL_SECONDS.count()
                v["sum"] = round(ITL_SECONDS.sum(), 6)
                v["value"] = None if p50 is None else round(p50 * 1e3, 3)
            elif slo.name == "error_rate":
                by = {
                    "completed": ENGINE_REQUESTS.value(outcome="completed"),
                    "error": ENGINE_REQUESTS.value(outcome="error"),
                    "timeout": ENGINE_REQUESTS.value(outcome="timeout"),
                    "admission_failed": ENGINE_REQUESTS.value(
                        outcome="admission_failed"
                    ),
                }
                total = sum(by.values())
                bad = total - by["completed"]
                v["count"] = int(total)
                v["value"] = (
                    None if total == 0 else round(bad / total, 6)
                )
            elif slo.name == "decode_tok_s_chip":
                rate = self._decode_rate()
                chips = _chip_count()
                v["chips"] = chips
                v["value"] = (
                    None if rate is None else round(rate / chips, 3)
                )
                if rate is None:
                    v["note"] = "insufficient data (need a rate window)"
            value = v.get("value")
            if value is None:
                v["pass"] = None
                v["burn_rate"] = None
            elif slo.direction == "lt":
                v["pass"] = value < slo.target
                v["burn_rate"] = round(value / slo.target, 4) \
                    if slo.target > 0 else None
            else:
                v["pass"] = value > slo.target
                # value == 0 would be an infinite burn; None keeps the
                # JSON strict-parser-safe (pass=False already says it all).
                v["burn_rate"] = round(slo.target / value, 4) \
                    if value > 0 else None
            self._track_breach(v)
            out.append(v)
        with self._lock:
            self._last = out
        return {
            "slos": out,
            "classes": self.class_report(),
            "error_budget": _env_float(_ENV_ERR, 0.01),
            "pass": all(v["pass"] is not False for v in out),
            "evaluated_at": time.time(),
        }

    def class_report(self) -> list[dict[str, Any]]:
        """Per-SLO-class attainment + burn rate, windowed over
        TelemetryHistory (5 m and 1 h) rather than instantaneous. Only
        classes that have seen traffic appear; attainment is
        completed / (completed + bad) where bad covers error, timeout,
        admission_failed, and shed; burn rate is the SRE convention
        (1 - attainment) / error_budget, > 1.0 = burning faster than the
        budget allows."""
        from . import (
            CLASS_ITL_SECONDS,
            CLASS_REQUESTS,
            CLASS_TTFT_SECONDS,
            SLO_CLASSES,
        )
        from . import history as _history

        budget = _env_float(_ENV_ERR, 0.01)
        h = _history.get_history()
        rows: list[dict[str, Any]] = []
        for cls in SLO_CLASSES:
            by = {
                outcome: CLASS_REQUESTS.value(
                    **{"class": cls, "outcome": outcome}
                )
                for outcome in (
                    "completed", "error", "timeout",
                    "admission_failed", "shed",
                )
            }
            total = sum(by.values())
            if total <= 0:
                continue
            bad = total - by["completed"]
            ttft = histogram_quantile(
                CLASS_TTFT_SECONDS, 0.95, **{"class": cls}
            )
            itl = histogram_quantile(
                CLASS_ITL_SECONDS, 0.95, **{"class": cls}
            )
            row: dict[str, Any] = {
                "class": cls,
                "requests": int(total),
                "bad": int(bad),
                "attainment": round(by["completed"] / total, 6),
                "ttft_p95_ms": (
                    None if ttft is None else round(ttft * 1e3, 3)
                ),
                "itl_p95_ms": (
                    None if itl is None else round(itl * 1e3, 3)
                ),
                "outcomes": {k: int(v) for k, v in by.items() if v},
                "windows": {},
            }
            for label, win in (("5m", 300.0), ("1h", 3600.0)):
                done = h.window_sum(f"class.{cls}.completed", win)
                wbad = h.window_sum(f"class.{cls}.bad", win)
                wtotal = done + wbad
                if wtotal <= 0:
                    continue
                att = done / wtotal
                row["windows"][label] = {
                    "requests": int(wtotal),
                    "attainment": round(att, 6),
                    "burn_rate": (
                        round((1.0 - att) / budget, 4)
                        if budget > 0 else None
                    ),
                }
            rows.append(row)
        return rows

    def _track_breach(self, v: dict[str, Any]) -> None:
        """Breach bookkeeping: a flight-ring ANOMALY on each pass->fail
        transition (with the verdict attached, so the dump shows WHAT
        breached — and, via the dump's appended attribution snapshot,
        where the device bytes were going when it happened), plus
        breached_for_s while it lasts. The anomaly path is rate-limited
        by the recorder, so a flapping SLO cannot fill the disk."""
        name = v["name"]
        now = time.perf_counter()
        if v["pass"] is False:
            first = self._breached_since.setdefault(name, now)
            v["breached_for_s"] = round(now - first, 3)
            if first == now:
                from .flight import get_recorder, record

                record(
                    "slo_breach", slo=name, value=v.get("value"),
                    target=v["target"], burn_rate=v.get("burn_rate"),
                )
                # Dump the ring (+ attribution/timeline context) so the
                # breach is a self-contained postmortem artifact.
                # count=False: this can run inside a /metrics scrape, and
                # a scrape must not mutate scrape-visible counters.
                get_recorder().anomaly(
                    "slo_breach", count=False, slo=name,
                    value=v.get("value"), target=v["target"],
                    burn_rate=v.get("burn_rate"),
                )
        else:
            self._breached_since.pop(name, None)

    # -- /metrics collector ------------------------------------------------
    def collect(self) -> list[str]:
        """Scrape-time exposition: opsagent_slo_pass / _burn_rate /
        _value gauges per SLO (evaluated fresh, so the scrape and the
        endpoint can never disagree)."""
        from .metrics import escape_label_value

        res = self.evaluate()
        lines = [
            "# HELP opsagent_slo_pass declared SLO pass (1) / fail (0) / "
            "no data (-1)",
            "# TYPE opsagent_slo_pass gauge",
        ]
        burns: list[str] = []
        values: list[str] = []
        for v in res["slos"]:
            tag = f'{{slo="{escape_label_value(v["name"])}"}}'
            ok = v["pass"]
            lines.append(
                f"opsagent_slo_pass{tag} "
                f"{-1 if ok is None else (1 if ok else 0)}"
            )
            if v.get("burn_rate") is not None:
                burns.append(
                    f"opsagent_slo_burn_rate{tag} {v['burn_rate']}"
                )
            if v.get("value") is not None:
                values.append(f"opsagent_slo_value{tag} {v['value']}")
        # One contiguous group per metric family (the exposition format
        # forbids interleaving families).
        if burns:
            lines.append("# TYPE opsagent_slo_burn_rate gauge")
            lines.extend(burns)
        if values:
            lines.append("# TYPE opsagent_slo_value gauge")
            lines.extend(values)
        return lines

    # -- background loop ---------------------------------------------------
    def start(self) -> None:
        """Background refresher (servers): keeps the rate window warm and
        the breach transitions timely even when nobody scrapes."""
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="slo-watchdog"
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
                self.evaluate()
            except Exception:  # noqa: BLE001 - the watchdog must survive
                log.exception("slo evaluation failed")

    def reset(self) -> None:
        """Test-isolation hook: drop rate snapshots and breach state."""
        with self._lock:
            self._snaps.clear()
        self._breached_since.clear()
        self.take_snapshot()


def _chip_count() -> int:
    try:
        import torch

        return max(1, torch.cuda.device_count())
    except Exception:  # noqa: BLE001
        return 1


_watchdog: SLOWatchdog | None = None
_watchdog_lock = threading.Lock()


def get_watchdog() -> SLOWatchdog:
    global _watchdog
    if _watchdog is None:
        with _watchdog_lock:
            if _watchdog is None:
                _watchdog = SLOWatchdog()
    return _watchdog


def evaluate() -> dict[str, Any]:
    """Module-level convenience: evaluate every declared SLO now."""
    return get_watchdog().evaluate()
