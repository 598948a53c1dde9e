"""``python -m opsagent_tpu_torch slo-check`` (the port's copy of
``opsagent_tpu/cli/slocheck.py``) — the CLI face of the SLO watchdog,
usable as a bench/CI gate.

Three sources, checked in this order:

- ``--url http://host:port`` — fetch ``GET /api/slo`` from a running
  server (agent server, serving engine, or the fleet router — the
  router aggregates every replica's verdicts with replica-prefixed
  names, so one breached replica breaches the fleet check);
- ``--bench BENCH.json`` — read the ``extra.slo`` verdicts bench.py folds
  into its result line (accepts a single JSON object or a JSONL file —
  the last line carrying ``extra.slo`` wins);
- neither — evaluate the declared SLOs against THIS process's metrics
  registry (useful after an in-process bench/library run).

Exit codes: 0 = every evaluated SLO passes, 1 = at least one breach,
2 = no verdicts available (unreachable server, empty registry, bench
line without ``extra.slo``) — distinct so CI can tell "failing" from
"not measured".
"""

from __future__ import annotations

import json
import sys
from typing import Any


def _fetch_url(url: str, timeout_s: float = 10.0) -> dict[str, Any]:
    from urllib.request import urlopen

    base = url.rstrip("/")
    if not base.endswith("/api/slo"):
        base += "/api/slo"
    with urlopen(base, timeout=timeout_s) as resp:  # noqa: S310 - operator URL
        return json.loads(resp.read().decode("utf-8"))


def _read_bench(path: str) -> dict[str, Any] | None:
    """The last ``extra.slo`` block in a BENCH json/jsonl file."""
    found: dict[str, Any] | None = None
    with open(path) as f:
        text = f.read()
    lines = [ln for ln in text.splitlines() if ln.strip()]
    for ln in lines:
        try:
            d = json.loads(ln)
        except json.JSONDecodeError:
            continue
        slo = d.get("extra", {}).get("slo") if isinstance(d, dict) else None
        if slo:
            found = slo
    if found is None and len(lines) != 1:
        # Maybe a pretty-printed single JSON document.
        try:
            d = json.loads(text)
            found = d.get("extra", {}).get("slo")
        except (json.JSONDecodeError, AttributeError):
            pass
    return found


def _format(verdicts: dict[str, Any]) -> str:
    rows = [
        f"{'slo':<22} {'value':>12} {'target':>10} {'burn':>7}  verdict"
    ]
    for v in verdicts.get("slos", []):
        value = v.get("value")
        burn = v.get("burn_rate")
        ok = v.get("pass")
        verdict = "PASS" if ok else ("FAIL" if ok is False else "NO DATA")
        rows.append(
            f"{v.get('name', '?'):<22} "
            f"{value if value is not None else '-':>12} "
            f"{v.get('target', '-'):>10} "
            f"{burn if burn is not None else '-':>7}  "
            f"{verdict} ({v.get('unit', '')})"
        )
    return "\n".join(rows)


def _format_class(c: dict[str, Any]) -> str:
    rows = [
        f"{'window':<10} {'requests':>9} {'attainment':>11} {'burn':>7}"
    ]
    att = c.get("attainment")
    rows.append(
        f"{'overall':<10} {c.get('requests', 0):>9} "
        f"{(f'{att * 100:.2f}%' if att is not None else '-'):>11} "
        f"{'-':>7}"
    )
    for name, w in (c.get("windows") or {}).items():
        watt = w.get("attainment")
        burn = w.get("burn_rate")
        rows.append(
            f"{name:<10} {w.get('requests', 0):>9} "
            f"{(f'{watt * 100:.2f}%' if watt is not None else '-'):>11} "
            f"{(f'{burn:.2f}' if burn is not None else '-'):>7}"
        )
    return "\n".join(rows)


def _check_class(verdicts: dict[str, Any], slo_class: str) -> int:
    """Gate one SLO class: breach when the class burns its error budget
    faster than 1x in any history window (or its overall attainment is
    under target). Exit codes match the global gate: 0/1/2."""
    classes = {
        c.get("class"): c for c in verdicts.get("classes", [])
    }
    c = classes.get(slo_class)
    if c is None or not c.get("requests"):
        print(
            f"slo-check: class {slo_class!r} has no traffic yet",
            file=sys.stderr,
        )
        return 2
    print(f"slo-check: class {slo_class}")
    print(_format_class(c))
    burned = [
        name
        for name, w in (c.get("windows") or {}).items()
        if (w.get("burn_rate") or 0.0) > 1.0 and w.get("requests")
    ]
    att = c.get("attainment")
    target = 1.0 - float(verdicts.get("error_budget", 0.01) or 0.01)
    if burned:
        print(
            f"slo-check: BREACH: class {slo_class} burn>1x over "
            f"{', '.join(sorted(burned))}",
            file=sys.stderr,
        )
        return 1
    if att is not None and att < target:
        print(
            f"slo-check: BREACH: class {slo_class} attainment "
            f"{att * 100:.2f}% < {target * 100:.2f}%",
            file=sys.stderr,
        )
        return 1
    return 0


def run_slo_check(url: str = "", bench: str = "", slo_class: str = "") -> int:
    try:
        if url:
            verdicts = _fetch_url(url)
        elif bench:
            verdicts = _read_bench(bench)
            if verdicts is None:
                print(
                    f"slo-check: {bench} carries no extra.slo block",
                    file=sys.stderr,
                )
                return 2
        else:
            from .. import obs

            verdicts = obs.slo.evaluate()
    except Exception as e:  # noqa: BLE001 - CI gate: report, exit 2
        print(f"slo-check: unavailable: {e}", file=sys.stderr)
        return 2
    if slo_class:
        return _check_class(verdicts, slo_class)
    fleet = verdicts.get("fleet")
    if fleet:
        print(
            f"slo-check: fleet rollup over {fleet.get('replicas', 0)} "
            f"replica(s)"
        )
    print(_format(verdicts))
    slos = verdicts.get("slos", [])
    if not slos or all(v.get("pass") is None for v in slos):
        print("slo-check: no SLO has data yet", file=sys.stderr)
        return 2
    failed = [v["name"] for v in slos if v.get("pass") is False]
    if failed:
        print(f"slo-check: BREACH: {', '.join(failed)}", file=sys.stderr)
        return 1
    return 0
