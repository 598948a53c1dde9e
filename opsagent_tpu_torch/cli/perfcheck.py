"""``python -m opsagent_tpu_torch perf-check`` — the perf-regression gate
(the port's copy of ``opsagent_tpu/cli/perfcheck.py``, same rows, verdicts,
output and exit codes).

Compares a fresh bench jsonl (result lines, one JSON object each) or a
fleet router's live rows (``GET /api/fleet/bench``) against a baseline
jsonl (``BENCH_r*_local.jsonl`` in the repo root, newest round by default)
metric by metric, with per-metric noise tolerances, and exits nonzero on
regression.

Semantics:

- Rows match by their ``metric`` string (e.g.
  ``fleet_ttft_p95[r0]``). Metrics present
  on only one side are reported but never gate (a new stage is not a
  regression; a skipped stage is the budget's business, not this
  gate's).
- When a file carries several rows of one metric (re-runs, the
  cold-restart probe re-using the 1B preset), the BEST row per side is
  compared — max for higher-is-better units, min for lower-is-better —
  so a deliberately-slow probe row can never mask or fake a regression.
- Direction comes from the unit: ``tok/s/chip`` (and any ``*/s*`` unit)
  is higher-better; ``ms``/``s`` are lower-better. Each row's
  ``extra.p50_ttft_ms`` is additionally gated as ``<metric> p50_ttft``
  (lower-better) when both sides carry it.
- Tolerance: relative, default 10 % (``DEFAULT_TOLERANCE``), overridable
  globally (``--tolerance 0.15``) or per metric substring via a JSON
  file (``--tolerances tol.json`` -> ``{"sessions": 0.2}``; longest
  matching substring wins). TTFT comparisons default looser
  (``DEFAULT_TTFT_TOLERANCE``, 25 %): latency percentiles are noisier
  than throughput means.

Exit codes mirror ``slo-check``: 0 = pass, 1 = regression, 2 = nothing
comparable (missing/empty files, zero overlapping metrics). Standard
library only.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any

DEFAULT_TOLERANCE = 0.10
DEFAULT_TTFT_TOLERANCE = 0.25

_REPO = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def load_rows(path: str) -> list[dict[str, Any]]:
    """Parse one jsonl (or single-json) file into result rows (dicts with
    a ``metric`` key); unparseable lines are skipped like bench_summary."""
    rows: list[dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                d = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(d, dict) and "metric" in d and "value" in d:
                rows.append(d)
    return rows


def fetch_rows(url: str, timeout_s: float = 10.0) -> list[dict[str, Any]]:
    """Live result rows from a running fleet router: GET
    /api/fleet/bench returns bench-line-shaped rows assembled from every
    replica's current SLO values, so the same compare() that gates bench
    jsonl files gates a running fleet. A bare router base URL gets the
    path appended; a URL already naming a path is fetched as-is."""
    from urllib.request import urlopen

    base = url.rstrip("/")
    if not base.endswith("/api/fleet/bench"):
        base += "/api/fleet/bench"
    with urlopen(base, timeout=timeout_s) as resp:  # noqa: S310 - operator URL
        data = json.loads(resp.read().decode("utf-8"))
    if not isinstance(data, list):
        return []
    return [
        d for d in data
        if isinstance(d, dict) and "metric" in d and "value" in d
    ]


def default_baseline() -> str | None:
    """The newest committed BENCH_r*_local.jsonl in the repo root."""
    paths = sorted(glob.glob(os.path.join(_REPO, "BENCH_r*_local.jsonl")))
    return paths[-1] if paths else None


def _higher_better(unit: str) -> bool:
    u = (unit or "").lower()
    if u in (
        "ms", "s", "seconds", "failed_requests", "errors",
        "request_ready_s", "ms/turn", "overhead_pct", "audit_latency_s",
    ):
        return False
    # tok/s/chip and friends — including prefix_hit_rate (a fan-out
    # whose children start re-prefilling the shared prefix regresses).
    return True


def _series(rows: list[dict[str, Any]]) -> dict[str, dict[str, Any]]:
    """{comparison name: {value, higher_better}} — best row per metric,
    plus the p50-TTFT sub-series where the extras carry one."""
    out: dict[str, dict[str, Any]] = {}
    for d in rows:
        name = d["metric"]
        try:
            value = float(d["value"])
        except (TypeError, ValueError):
            continue
        hb = _higher_better(d.get("unit", ""))
        cur = out.get(name)
        if cur is None or (value > cur["value"]) == hb:
            out[name] = {"value": value, "higher_better": hb}
        ttft = (d.get("extra") or {}).get("p50_ttft_ms")
        if ttft is not None:
            tname = f"{name} p50_ttft"
            try:
                tval = float(ttft)
            except (TypeError, ValueError):
                continue
            if tval <= 0:
                continue  # "0.0" = not measured in that mode
            tcur = out.get(tname)
            if tcur is None or tval < tcur["value"]:
                out[tname] = {
                    "value": tval, "higher_better": False, "ttft": True,
                }
    return out


def _tolerance_for(
    name: str, entry: dict[str, Any],
    tolerance: float | None, per_metric: dict[str, float] | None,
) -> float:
    if per_metric:
        hits = [k for k in per_metric if k in name]
        if hits:
            return float(per_metric[max(hits, key=len)])
    if tolerance is not None:
        return float(tolerance)
    return (
        DEFAULT_TTFT_TOLERANCE if entry.get("ttft") else DEFAULT_TOLERANCE
    )


def compare(
    current_rows: list[dict[str, Any]],
    baseline_rows: list[dict[str, Any]],
    tolerance: float | None = None,
    per_metric: dict[str, float] | None = None,
) -> dict[str, Any]:
    """The gate's pure core: per-metric verdicts + the overall one.
    A metric regresses when it moved past its noise tolerance in the bad
    direction (relative to the baseline value)."""
    cur = _series(current_rows)
    base = _series(baseline_rows)
    verdicts: list[dict[str, Any]] = []
    regressions = 0
    compared = 0
    for name in sorted(set(cur) | set(base)):
        c, b = cur.get(name), base.get(name)
        if c is None or b is None:
            verdicts.append({
                "metric": name,
                "status": "current_only" if b is None else "baseline_only",
            })
            continue
        compared += 1
        tol = _tolerance_for(name, c, tolerance, per_metric)
        hb = b["higher_better"]
        bv, cv = b["value"], c["value"]
        if bv == 0:
            ratio = None
            bad = False
        else:
            ratio = cv / bv
            bad = (ratio < 1.0 - tol) if hb else (ratio > 1.0 + tol)
        verdicts.append({
            "metric": name,
            "status": "regression" if bad else "ok",
            "baseline": bv,
            "current": cv,
            "ratio": None if ratio is None else round(ratio, 4),
            "tolerance": tol,
            "direction": "higher_better" if hb else "lower_better",
        })
        if bad:
            regressions += 1
    return {
        "compared": compared,
        "regressions": regressions,
        "pass": None if compared == 0 else regressions == 0,
        "verdicts": verdicts,
    }


def format_report(report: dict[str, Any]) -> str:
    lines = [
        f"{'metric':62s} {'baseline':>10s} {'current':>10s} "
        f"{'ratio':>7s} {'tol':>5s}  verdict"
    ]
    for v in report["verdicts"]:
        if "baseline" not in v:
            lines.append(f"{v['metric'][:62]:62s} {'—':>10s} {'—':>10s} "
                         f"{'—':>7s} {'—':>5s}  {v['status']}")
            continue
        ratio = v["ratio"]
        lines.append(
            f"{v['metric'][:62]:62s} {v['baseline']:>10.1f} "
            f"{v['current']:>10.1f} "
            f"{'—' if ratio is None else f'{ratio:.3f}':>7s} "
            f"{v['tolerance']:>5.0%}  "
            f"{'REGRESSION' if v['status'] == 'regression' else 'ok'}"
        )
    if report["pass"] is None:
        lines.append("perf-check: NO COMPARABLE METRICS (exit 2)")
    elif report["pass"]:
        lines.append(
            f"perf-check: PASS ({report['compared']} metrics compared)"
        )
    else:
        lines.append(
            f"perf-check: FAIL ({report['regressions']} regression(s) "
            f"over {report['compared']} compared metrics)"
        )
    return "\n".join(lines)


def run_perf_check(
    current: str,
    baseline: str = "",
    tolerance: float | None = None,
    tolerances_file: str = "",
) -> int:
    """CLI body. Exit 0 pass, 1 regression, 2 nothing comparable."""
    import sys

    baseline = baseline or (default_baseline() or "")
    if not baseline or not os.path.exists(baseline):
        print("perf-check: no baseline jsonl found", file=sys.stderr)
        return 2
    from_url = current.startswith(("http://", "https://"))
    if not from_url and (not current or not os.path.exists(current)):
        print(f"perf-check: current file not found: {current!r}",
              file=sys.stderr)
        return 2
    per_metric = None
    if tolerances_file:
        try:
            with open(tolerances_file) as f:
                per_metric = {k: float(v) for k, v in json.load(f).items()}
        except (OSError, ValueError, AttributeError) as e:
            print(f"perf-check: bad --tolerances file: {e}", file=sys.stderr)
            return 2
    if from_url:
        try:
            current_rows = fetch_rows(current)
        except Exception as e:  # noqa: BLE001 - CI gate: report, exit 2
            print(f"perf-check: fleet unreachable: {e}", file=sys.stderr)
            return 2
    else:
        current_rows = load_rows(current)
    report = compare(
        current_rows, load_rows(baseline),
        tolerance=tolerance, per_metric=per_metric,
    )
    print(f"perf-check: current={current} baseline={baseline}")
    print(format_report(report))
    if report["pass"] is None:
        return 2
    return 0 if report["pass"] else 1


def main(argv: list[str]) -> int:
    """scripts/perf_gate.py entrypoint (argparse kept here so the script
    stays a two-line shim)."""
    import argparse

    p = argparse.ArgumentParser(
        prog="perf_gate",
        description="compare a fresh bench jsonl against the committed "
                    "baseline; exit 1 on regression",
    )
    p.add_argument(
        "current",
        help="fresh bench jsonl (result lines), or a running fleet "
             "router's base URL (http://...: live rows are fetched from "
             "GET /api/fleet/bench)",
    )
    p.add_argument(
        "--baseline", default="",
        help="baseline jsonl (default: newest BENCH_r*_local.jsonl)",
    )
    p.add_argument(
        "--tolerance", type=float, default=None,
        help=f"global relative tolerance (default "
             f"{DEFAULT_TOLERANCE:.0%}, TTFT {DEFAULT_TTFT_TOLERANCE:.0%})",
    )
    p.add_argument(
        "--tolerances", default="",
        help="JSON file of {metric substring: tolerance} overrides",
    )
    a = p.parse_args(argv)
    return run_perf_check(
        a.current, baseline=a.baseline, tolerance=a.tolerance,
        tolerances_file=a.tolerances,
    )
