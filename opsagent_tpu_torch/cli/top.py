"""``python -m opsagent_tpu_torch top`` (the port's copy of
``opsagent_tpu/cli/top.py``, frame text identical) — a live fleet cockpit
over the public read-only
observability endpoints, curses-free (plain ANSI) so it runs anywhere a
terminal does and renders frame-bounded into a file for tests.

One frame per poll interval, assembled from:

- ``GET /api/fleet`` — the replica table (role, health-breaker state,
  queue depth, batch occupancy, MFU, clock skew). Absent (404 /
  connection refused against a bare engine server) the cockpit degrades
  to a single-node view.
- ``GET /api/slo`` — per-class SLO rows (attainment, burn, p95s) from
  the ``classes`` block ``obs.slo.evaluate()`` folds in.
- ``GET /api/metrics/history`` — the telemetry time machine; sparklines
  of decode rate and per-class completions over the last ~2 minutes.
- ``GET /api/fleet/flight?kind=anomaly`` — the fleet flight ledger's
  anomaly tail (replica-tagged, skew-corrected).

No third-party deps: urllib + ANSI escapes. When ``out`` is not a TTY
(piped, or the test harness) the screen-clear escapes are suppressed and
frames are separated by a rule line instead.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any, TextIO
from urllib.parse import quote
from urllib.request import urlopen

SPARK = " ▁▂▃▄▅▆▇█"
_CLEAR = "\x1b[2J\x1b[H"
_BOLD = "\x1b[1m"
_DIM = "\x1b[2m"
_RED = "\x1b[31m"
_GREEN = "\x1b[32m"
_YELLOW = "\x1b[33m"
_RESET = "\x1b[0m"

# decode rate + per-class completion rates drive the sparklines; 10 s
# buckets over 2 minutes keeps a frame to ~12 cells per row.
_SPARK_WINDOW_S = 120.0
_SPARK_STEP_S = 10.0


def _fetch(url: str, timeout_s: float = 5.0) -> dict[str, Any] | None:
    try:
        with urlopen(url, timeout=timeout_s) as resp:  # noqa: S310
            return json.loads(resp.read().decode("utf-8"))
    except Exception:  # noqa: BLE001 - cockpit degrades per-panel
        return None


def sparkline(points: list[list[float]], width: int = 12) -> str:
    """[[ts, value], ...] -> a fixed-width unicode sparkline (newest
    right-aligned; empty cells pad the left)."""
    vals = [float(p[1]) for p in points][-width:]
    if not vals:
        return "·" * width
    hi = max(vals)
    cells = ""
    for v in vals:
        if hi <= 0:
            cells += SPARK[1]
        else:
            idx = 1 + int(round((len(SPARK) - 2) * (v / hi)))
            cells += SPARK[max(1, min(len(SPARK) - 1, idx))]
    return cells.rjust(width, " ")


class _Palette:
    """ANSI codes, or empty strings when color is off."""

    def __init__(self, enabled: bool):
        self.bold = _BOLD if enabled else ""
        self.dim = _DIM if enabled else ""
        self.red = _RED if enabled else ""
        self.green = _GREEN if enabled else ""
        self.yellow = _YELLOW if enabled else ""
        self.reset = _RESET if enabled else ""

    def health(self, state: str) -> str:
        if state == "healthy":
            return f"{self.green}{state}{self.reset}"
        if state == "suspect":
            return f"{self.yellow}{state}{self.reset}"
        return f"{self.red}{state}{self.reset}"

    def verdict(self, ok: Any) -> str:
        if ok is True:
            return f"{self.green}PASS{self.reset}"
        if ok is False:
            return f"{self.red}FAIL{self.reset}"
        return f"{self.dim}-{self.reset}"


def _replica_rows(fleet: dict[str, Any], p: _Palette) -> list[str]:
    rows = [
        f"{'replica':<16} {'role':<8} {'health':<9} {'queue':>5} "
        f"{'occ':>6} {'mfu':>6} {'skew':>9} {'slo':>6}"
    ]
    for r in fleet.get("replicas", []):
        load = r.get("load", {}) or {}
        running = load.get("running", 0)
        cap = r.get("capacity", 0) or 0
        occ = f"{running}/{cap}" if cap else str(running)
        mfu = load.get("mfu")
        mfu_s = f"{float(mfu) * 100:5.1f}%" if mfu is not None else "     -"
        skew = r.get("clock_offset_s", 0.0) or 0.0
        slo = (r.get("slo") or {}).get("pass")
        health = r.get("health", "healthy")
        # ANSI codes break f-string width padding; pad the raw text.
        rows.append(
            f"{r.get('id', '?'):<16} {r.get('role', '?'):<8} "
            f"{health:<9} {load.get('queued', 0):>5} "
            f"{occ:>6} {mfu_s:>6} {skew * 1e3:>+7.1f}ms "
            f"{'PASS' if slo is True else 'FAIL' if slo is False else '-':>6}"
        )
    return rows


def _class_rows(
    slo: dict[str, Any], hist: dict[str, Any] | None, p: _Palette
) -> list[str]:
    classes = (slo or {}).get("classes", [])
    rows = [
        f"{'class':<12} {'reqs':>6} {'attain':>7} {'burn5m':>7} "
        f"{'ttft p95':>9} {'itl p95':>8}  trend"
    ]
    series = (hist or {}).get("series", {})
    for c in classes:
        cls = c.get("class", "?")
        att = c.get("attainment")
        w5 = (c.get("windows") or {}).get("5m", {})
        burn = w5.get("burn_rate")
        ttft = c.get("ttft_p95_ms")
        itl = c.get("itl_p95_ms")
        spark = sparkline(
            _series_points(series, f"class.{cls}.completed")
        )
        rows.append(
            f"{cls:<12} {c.get('requests', 0):>6} "
            f"{(f'{att * 100:5.1f}%' if att is not None else '    -'):>7} "
            f"{(f'{burn:5.2f}' if burn is not None else '    -'):>7} "
            f"{(f'{ttft:7.1f}ms' if ttft is not None else '       -'):>9} "
            f"{(f'{itl:6.1f}ms' if itl is not None else '      -'):>8}  "
            f"{spark}"
        )
    if not classes:
        rows.append(f"{p.dim}(no classified traffic yet){p.reset}")
    return rows


def _series_points(
    series: dict[str, Any], name: str
) -> list[list[float]]:
    """Points for ``name``; on a router payload the local series sits
    unprefixed and remote replicas as ``{rid}:{name}`` — sum the lot so
    the sparkline is fleet-wide."""
    merged: dict[float, float] = {}
    for key, body in series.items():
        if key != name and not key.endswith(f":{name}"):
            continue
        for ts, v in body.get("points", []):
            merged[ts] = merged.get(ts, 0.0) + v
    return [[ts, merged[ts]] for ts in sorted(merged)]


def _series_last(
    series: dict[str, Any], name: str, agg: str = "sum"
) -> float | None:
    """Latest value of ``name`` across the local and ``{rid}:``-prefixed
    replica series (sum for counts, max for rates/ratios); None when no
    series carries a point."""
    vals: list[float] = []
    for key, body in series.items():
        if key != name and not key.endswith(f":{name}"):
            continue
        points = body.get("points", [])
        if points:
            vals.append(float(points[-1][1]))
    if not vals:
        return None
    return max(vals) if agg == "max" else sum(vals)


def _fanout_row(hist: dict[str, Any] | None, p: _Palette) -> list[str]:
    """One cockpit row for audit fan-outs (agent/fanout): active count,
    children done/planned of the newest fan-out, shared-prefix hit rate,
    and the child completion trend — all via the history sampler."""
    series = (hist or {}).get("series", {})
    active = _series_last(series, "fanout.active")
    done = _series_last(series, "fanout.children_done")
    planned = _series_last(series, "fanout.children_planned")
    hit = _series_last(series, "fanout.prefix_hit_rate", agg="max")
    if not any(v for v in (active, done, planned)):
        return [f"{p.dim}(no fan-outs observed){p.reset}"]
    spark = sparkline(_series_points(series, "fanout.children"))
    return [
        f"{'active':<8} {'children':>12} {'prefix hit':>11}  trend",
        f"{int(active or 0):<8} "
        f"{f'{int(done or 0)}/{int(planned or 0)}':>12} "
        f"{(f'{hit * 100:9.1f}%' if hit is not None else '         -'):>11}"
        f"  {spark}",
    ]


def _anomaly_rows(
    flight: dict[str, Any] | None, p: _Palette, n: int = 5
) -> list[str]:
    events = (flight or {}).get("events", [])[-n:]
    if not events:
        return [f"{p.dim}(no anomalies in the ledger){p.reset}"]
    rows = []
    for e in events:
        wall = e.get("wall_corrected", e.get("wall", 0.0))
        age = max(0.0, time.time() - wall)
        rows.append(
            f"{age:>6.1f}s ago  {e.get('replica', e.get('source', '?')):<12} "
            f"{e.get('reason', '?'):<20} {e.get('request_id', '')}"
        )
    return rows


def render_frame(
    fleet: dict[str, Any] | None,
    slo: dict[str, Any] | None,
    hist: dict[str, Any] | None,
    flight: dict[str, Any] | None,
    p: _Palette,
) -> str:
    lines: list[str] = []
    stamp = time.strftime("%H:%M:%S")
    spark = sparkline(
        _series_points((hist or {}).get("series", {}), "decode_tokens"),
        width=24,
    )
    lines.append(
        f"{p.bold}opsagent top{p.reset}  {stamp}   "
        f"decode tok/s trend: {spark}"
    )
    lines.append("")
    if fleet is not None:
        lines.append(f"{p.bold}replicas{p.reset}")
        lines.extend(_replica_rows(fleet, p))
    else:
        lines.append(
            f"{p.bold}replicas{p.reset}  "
            f"{p.dim}(no /api/fleet — single-node view){p.reset}"
        )
    lines.append("")
    lines.append(f"{p.bold}slo classes{p.reset}")
    lines.extend(_class_rows(slo or {}, hist, p))
    lines.append("")
    lines.append(f"{p.bold}audit fan-out{p.reset}")
    lines.extend(_fanout_row(hist, p))
    lines.append("")
    lines.append(f"{p.bold}anomaly tail{p.reset}")
    lines.extend(_anomaly_rows(flight, p))
    return "\n".join(lines) + "\n"


def run_top(
    url: str,
    interval_s: float = 2.0,
    frames: int = 0,
    out: TextIO | None = None,
    color: bool | None = None,
) -> int:
    """Poll ``url`` and render cockpit frames until interrupted (or for
    ``frames`` frames when positive — the test/scripting mode). Returns
    0 when at least one endpoint answered, 1 when nothing ever did."""
    out = out if out is not None else sys.stdout
    tty = bool(getattr(out, "isatty", lambda: False)())
    p = _Palette(color if color is not None else tty)
    base = url.rstrip("/")
    rendered = 0
    got_data = False
    wanted = ",".join(
        ["decode_tokens"]
        + [f"class.{c}.completed"
           for c in ("interactive", "batch", "background")]
        + [f"fanout.{s}" for s in (
            "active", "children_planned", "children_done",
            "prefix_hit_rate", "children",
        )]
    )
    hist_q = (
        f"?since={_SPARK_WINDOW_S}&step={_SPARK_STEP_S}"
        f"&series={quote(wanted)}"
    )
    try:
        while True:
            fleet = _fetch(base + "/api/fleet")
            slo = _fetch(base + "/api/slo")
            hist = _fetch(base + "/api/metrics/history" + hist_q)
            flight = _fetch(base + "/api/fleet/flight?kind=anomaly&n=16")
            got_data = got_data or any(
                x is not None for x in (fleet, slo, hist, flight)
            )
            frame = render_frame(fleet, slo, hist, flight, p)
            if tty:
                out.write(_CLEAR + frame)
            else:
                if rendered:
                    out.write("-" * 72 + "\n")
                out.write(frame)
            out.flush()
            rendered += 1
            if frames and rendered >= frames:
                break
            time.sleep(interval_s)
    except KeyboardInterrupt:
        pass
    return 0 if got_data else 1
