"""Reduces a ``torch.profiler`` Chrome trace of the serving loop to what
the per-layer readers need.

Every device operation (kernel, copy, set) is tied through its
correlation id to the host call that launched it (a kernel launch or a
CUDA graph's replay), and that call to the engine's range around it on
the scheduler thread (``engine.mixed_step``, ``engine.mixed_step_async``,
``engine.decode_block``, ...: the port's ``annotate`` names). The
benchmark's markers ``portbench.attr.<i>``, recorded on the same thread
when the engine hands a dispatch's composition to its attribution hook,
tie composition ``i`` to the range just before it. The traced window is
the span of the host events; the device is busy where any operation
runs."""

from __future__ import annotations

import bisect
import json
import re
from dataclasses import dataclass, field

MARK = "portbench.attr."
RANGE_PREFIX = "engine."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclass
class Occurrence:
    """One engine range: its name, the device seconds of what it launched
    (by operation name) and the compositions recorded in it."""

    name: str
    start_us: float
    ops: dict[str, float] = field(default_factory=dict)
    comps: list[int] = field(default_factory=list)

    @property
    def device_s(self) -> float:
        return sum(self.ops.values())

    def matching_s(self, pattern: str) -> float:
        rx = re.compile(pattern)
        return sum(s for name, s in self.ops.items() if rx.search(name))


@dataclass
class Summary:
    window_s: float
    busy_s: float
    occurrences: list[Occurrence]
    top_ops: list[list]       # [[name, seconds], ...] longest first
    idle_gaps: list[list]     # [[what the host was doing, seconds], ...]


def short_name(name: str) -> str:
    """A kernel's name without its return type and template arguments."""
    name = re.sub(r"^void\s+", "", name)
    return re.split(r"[<(]", name, maxsplit=1)[0].strip() or name


def summarize(path: str) -> Summary:
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    host = [e for e in events if e.get("cat") not in DEVICE_CATS
            and not str(e.get("cat", "")).startswith("gpu_")]
    ranges = [e for e in host if e.get("cat") == "user_annotation"
              and e["name"].startswith(RANGE_PREFIX)]
    if not ranges:
        raise ValueError("the trace holds no engine range")
    tid = max({e["tid"] for e in ranges}, key=lambda t: sum(r["tid"] == t for r in ranges))
    ranges = sorted((e for e in ranges if e["tid"] == tid), key=lambda e: e["ts"])
    occ = [Occurrence(e["name"], float(e["ts"])) for e in ranges]
    starts = [o.start_us for o in occ]
    ends = [float(e["ts"]) + float(e["dur"]) for e in ranges]

    def inside(ts: float) -> int | None:
        i = bisect.bisect_right(starts, ts) - 1
        return i if i >= 0 and ts <= ends[i] else None

    launch = {e["args"]["correlation"]: inside(float(e["ts"])) for e in host
              if e.get("cat") in LAUNCH_CATS and e.get("tid") == tid
              and "correlation" in e.get("args", {})}
    for e in host:
        if e.get("cat") == "user_annotation" and e["name"].startswith(MARK) and e["tid"] == tid:
            i = bisect.bisect_right(starts, float(e["ts"])) - 1
            if i >= 0:
                occ[i].comps.append(int(e["name"][len(MARK):]))

    t0 = min(float(e["ts"]) for e in host)
    t1 = max(float(e["ts"]) + float(e.get("dur", 0)) for e in host)
    spans, totals = [], {}
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        spans.append((a, b))
        name = short_name(e["name"])
        totals[name] = totals.get(name, 0.0) + (b - a) * 1e-6
        i = launch.get(e.get("args", {}).get("correlation"))
        if i is not None:
            occ[i].ops[name] = occ[i].ops.get(name, 0.0) + (b - a) * 1e-6
    busy, gaps, edge = 0.0, [], t0
    for a, b in sorted(spans):
        if a > edge:
            gaps.append((edge, a))
        if b > edge:
            busy += b - max(a, edge)
            edge = b
    if t1 > edge:
        gaps.append((edge, t1))
    top = sorted(totals.items(), key=lambda kv: -kv[1])[:10]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return Summary(
        window_s=(t1 - t0) * 1e-6, busy_s=busy * 1e-6, occurrences=occ,
        top_ops=[[n, s] for n, s in top],
        idle_gaps=[[_doing(host, tid, (a + b) / 2), (b - a) * 1e-6] for a, b in longest],
    )


def _doing(host: list[dict], tid, ts: float) -> str:
    """The innermost host event on the scheduler thread at ``ts``."""
    best = None
    for e in host:
        if e.get("tid") == tid and e["ts"] <= ts <= e["ts"] + e.get("dur", 0):
            if best is None or e.get("dur", 0) < best.get("dur", 0):
                best = e
    return f"{best.get('cat', '')}:{best['name']}" if best else "scheduler thread idle"
