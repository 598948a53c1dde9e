"""Goodput ledger, part 2: per-request lifecycle timelines (the port's copy of
``opsagent_tpu/obs/timeline.py``).

Traces (obs/trace.py) hold one request's span tree; the flight ring
(obs/flight.py) holds the engine's event stream. Neither alone answers
the operator question "where did THIS request's wall clock go — queue,
prefill, decode, or blocked on a tool?". This module assembles both into
one timeline per request ID:

- **phases**: a non-overlapping, gap-free segmentation of the request's
  wall clock (queued -> prefill -> decode -> tool_blocked -> ...), built
  from the trace spans with flight tool-entry/exit events bounding the
  tool windows exactly, and residual time labeled ``host`` (chat
  translation, detokenize-adjacent work) so coverage is complete rather
  than silently partial;
- **goodput**: the per-request fraction split (decode_active vs
  tool_blocked vs queued vs prefill vs host) — the number ROADMAP item 2
  (Conveyor-style tool overlap) will move;
- **events**: the flight-ring events attributable to the request
  (admission / dispatch / ttft / tool enter+exit / park / restore /
  finish), stitched ACROSS engine generations: a restart re-admits the
  request under a new seq_id with the same request ID, and both
  generations' events land in one timeline.

Served at ``GET /api/timeline/{request_id}`` on both servers and
rendered by ``opsagent timeline`` as an ASCII Gantt. Everything here is
read-side host work — no instrumentation is added to the hot path.
"""

from __future__ import annotations

import time
from typing import Any

from .flight import get_recorder
from .trace import Span, get_store

# Span names that map onto timeline phases. Children of "decode"
# (decode_block / mixed_step / decode_step) stay inside their parent —
# they overlap by design under pipelining and would shred the sweep.
PHASE_OF_SPAN = {
    "queue_wait": "queued",
    "prefill": "prefill",
    "decode": "decode_active",
    "tool_exec": "tool_blocked",
    "detokenize": "host",
}

# Flight-event kinds attributable to a request via request_id or its
# seq_ids (dispatch events carry seq-id lists, not request ids).
_SEQ_LIST_KEYS = ("seq_ids", "decode_seq_ids", "prefill_seq_ids")


def _collect_span_intervals(
    span: Span, out: list[tuple[str, float, float, dict]], now: float
) -> None:
    phase = PHASE_OF_SPAN.get(span.name)
    if phase is not None:
        t1 = span.t1 if span.t1 is not None else now
        attrs = dict(span.attrs)
        attrs["span"] = span.name
        out.append((phase, span.t0, t1, attrs))
        if span.name != "decode":
            return  # mapped leaves don't nest further phases
    for child in list(span.children):
        _collect_span_intervals(child, out, now)


def _tool_windows_from_events(
    events: list[dict[str, Any]]
) -> list[tuple[str, float, float, dict]]:
    """Pair tool_exec enter/exit flight events into exact tool-blocked
    windows. Unpaired enters (tool still running) extend to the last
    event's ts — visibly open rather than dropped."""
    out: list[tuple[str, float, float, dict]] = []
    open_enters: list[dict[str, Any]] = []
    last_ts = max((e["ts"] for e in events), default=0.0)
    for e in events:
        if e.get("kind") != "tool_exec":
            continue
        if e.get("phase") == "enter":
            open_enters.append(e)
        elif e.get("phase") == "exit" and open_enters:
            ent = open_enters.pop()
            attrs = {
                "tool": e.get("tool"),
                "outcome": e.get("outcome"),
                "source": "flight",
            }
            # Conveyor launches mark both halves of the pair; the enter
            # additionally carries how far into decode the launch fired.
            if ent.get("conveyor") or e.get("conveyor"):
                attrs["conveyor"] = True
            if ent.get("launch_offset_ms") is not None:
                attrs["launch_offset_ms"] = ent["launch_offset_ms"]
            out.append(("tool_blocked", ent["ts"], e["ts"], attrs))
    for ent in open_enters:
        out.append((
            "tool_blocked", ent["ts"], last_ts,
            {"tool": ent.get("tool"), "open": True, "source": "flight"},
        ))
    return out


def _sweep(
    intervals: list[tuple[str, float, float, dict]],
    t0: float,
    t1: float,
    min_gap_s: float = 1e-4,
) -> list[dict[str, Any]]:
    """Turn possibly-overlapping phase intervals into a non-overlapping,
    gap-free segmentation of [t0, t1]: intervals are clipped against the
    sweep cursor in start order (same-phase duplicates — a tool window
    seen as both a span and a flight pair — merge naturally), and any
    residue between mapped segments becomes a ``host`` segment, so the
    phases partition the request's wall clock completely."""
    segs: list[dict[str, Any]] = []
    cursor = t0

    def emit(phase: str, a: float, b: float, attrs: dict | None = None):
        if b - a <= 0:
            return
        if (
            segs
            and segs[-1]["phase"] == phase
            and abs(segs[-1]["_t1"] - a) < 1e-9
            and not attrs
        ):
            segs[-1]["_t1"] = b
            return
        segs.append({"phase": phase, "_t0": a, "_t1": b,
                     **({"attrs": attrs} if attrs else {})})

    for phase, a, b, attrs in sorted(intervals, key=lambda x: (x[1], -x[2])):
        a = max(a, cursor, t0)
        b = min(max(b, a), t1)
        if b - a <= 0:
            continue
        if a - cursor > min_gap_s:
            emit("host", cursor, a)
        elif a > cursor:
            a = cursor  # swallow sub-threshold gap into this segment
        emit(phase, a, b, attrs if attrs else None)
        cursor = b
    if t1 - cursor > min_gap_s:
        emit("host", cursor, t1)
    for s in segs:
        s["start_ms"] = round((s.pop("_t0") - t0) * 1e3, 3)
        end = s.pop("_t1")
        s["end_ms"] = round((end - t0) * 1e3, 3)
        s["duration_ms"] = round(s["end_ms"] - s["start_ms"], 3)
    return segs


def _relevant_events(
    request_id: str, events: list[dict[str, Any]]
) -> tuple[list[dict[str, Any]], set[int], int]:
    """Flight events attributable to this request, the seq_ids it wore
    (one per engine generation it was admitted under), and the number of
    engine restarts observed inside its event window."""
    seq_ids: set[int] = set()
    for e in events:
        if e.get("request_id") == request_id and "seq_id" in e:
            seq_ids.add(e["seq_id"])
    picked: list[dict[str, Any]] = []
    for e in events:
        if e.get("request_id") == request_id:
            picked.append(e)
            continue
        if e.get("seq_id") in seq_ids and "request_id" not in e:
            picked.append(e)
            continue
        if any(
            seq_ids.intersection(e.get(k) or ()) for k in _SEQ_LIST_KEYS
        ):
            picked.append(e)
    restarts = 0
    if picked:
        lo = min(e["ts"] for e in picked)
        hi = max(e["ts"] for e in picked)
        for e in events:
            if e.get("kind") == "anomaly" and e.get("reason") == "engine_restart":
                if lo <= e["ts"] <= hi:
                    restarts += 1
                    picked.append(e)
    picked.sort(key=lambda e: e["ts"])
    return picked, seq_ids, restarts


def assemble(request_id: str) -> dict[str, Any] | None:
    """Build the timeline for one request from the live trace store and
    flight ring. Returns None when NOTHING is known about the id (no
    trace and no flight events). Works mid-flight (open spans extend to
    now) and across engine restarts (seq_ids accumulate per generation,
    and the trace's re-admission spans segment the second prefill/decode
    pass like the first)."""
    now = time.perf_counter()
    trace = get_store().get(request_id)
    events, seq_ids, restarts = _relevant_events(
        request_id, get_recorder().snapshot()
    )
    if trace is None and not events:
        return None

    intervals: list[tuple[str, float, float, dict]] = []
    if trace is not None:
        t0 = trace.root.t0
        t1 = trace.root.t1 if trace.root.t1 is not None else now
        _collect_span_intervals(trace.root, intervals, now)
    else:
        # Trace evicted (ring of 512): reconstruct coarse phases from the
        # flight events alone — admission->ttft is prefill, ttft->finish
        # decode, per engine generation.
        t0 = min(e["ts"] for e in events)
        t1 = max(e["ts"] for e in events)
        adm = {e["seq_id"]: e["ts"] for e in events
               if e.get("kind") == "admission"}
        ttft = {e["seq_id"]: e["ts"] for e in events
                if e.get("kind") == "ttft"}
        fin = {e["seq_id"]: e["ts"] for e in events
               if e.get("kind") == "finish"}
        for sid, a in adm.items():
            ft = ttft.get(sid)
            if ft is not None:
                intervals.append(("prefill", a, ft, {"seq_id": sid}))
                end = fin.get(sid, t1)
                intervals.append(("decode_active", ft, end, {"seq_id": sid}))
    if intervals:
        # Fleet hops can nest a later leg's spans under an already-closed
        # root (an in-process failover leg adopts the journey's existing
        # trace), so the request window must cover every collected
        # interval, not just the root span.
        t0 = min([t0] + [iv[1] for iv in intervals])
        t1 = max([t1] + [iv[2] for iv in intervals])
    tool_ivs = [
        iv for iv in _tool_windows_from_events(events)
        if t0 <= iv[1] <= t1 or t0 <= iv[2] <= t1
    ]
    intervals.extend(tool_ivs)
    phases = _sweep(intervals, t0, t1)

    # Conveyor overlap: the stretch of each early-launched tool window
    # that ran concurrently with decode. The sweep hides it by design
    # (its phases partition wall clock, and concurrent time IS decode),
    # so it is surfaced as separate windows rather than a phase.
    decode_ivs = [(a, b) for ph, a, b, _ in intervals
                  if ph == "decode_active"]
    overlap_windows: list[dict[str, Any]] = []
    for _ph, a, b, attrs in tool_ivs:
        if not attrs.get("conveyor"):
            continue
        for da, db in decode_ivs:
            oa, ob = max(a, da), min(b, db)
            if ob - oa > 1e-6:
                overlap_windows.append({
                    "tool": attrs.get("tool"),
                    "start_ms": round((oa - t0) * 1e3, 3),
                    "end_ms": round((ob - t0) * 1e3, 3),
                    "duration_ms": round((ob - oa) * 1e3, 3),
                })
    overlap_windows.sort(key=lambda w: w["start_ms"])
    tool_overlap_ms = round(
        sum(w["duration_ms"] for w in overlap_windows), 3
    )

    total_ms = max(1e-9, (t1 - t0) * 1e3)
    by_phase: dict[str, float] = {}
    for s in phases:
        by_phase[s["phase"]] = by_phase.get(s["phase"], 0.0) + s["duration_ms"]
    goodput = {
        p: round(by_phase.get(p, 0.0) / total_ms, 4)
        for p in ("decode_active", "tool_blocked", "queued", "prefill", "host")
    }
    goodput["coverage"] = round(sum(by_phase.values()) / total_ms, 4)

    ev_out = []
    for e in events:
        d = dict(e)
        d["t_ms"] = round((d.pop("ts") - t0) * 1e3, 3)
        ev_out.append(d)

    # Wall-clock anchor for cross-process stitching: perf_counter spans
    # are process-local, so the fleet stitcher needs the absolute wall
    # instant of this timeline's origin. Derived from any flight event
    # (which carries both clocks), else from the current instant — both
    # clocks advance at the same rate, so the conversion holds.
    anchor = next((e for e in events if "wall" in e), None)
    if anchor is not None:
        t0_wall = anchor["wall"] - (anchor["ts"] - t0)
    else:
        t0_wall = time.time() - (now - t0)

    # Replica-tagged hop windows: the router stamps every dispatched leg
    # with a fleet hop, the frontend tags the adopted span tree with the
    # serving replica (root attrs for leg 1, nested fleet_hop spans for
    # later legs), and the stitcher uses these windows to split a shared
    # in-process trace into per-replica lanes.
    fleet_legs: list[dict[str, Any]] = []
    if trace is not None:
        if trace.root.attrs.get("replica"):
            fleet_legs.append({
                "replica": str(trace.root.attrs["replica"]),
                "hop": str(trace.root.attrs.get("hop", "route")),
                "start_ms": 0.0,
                "end_ms": round((t1 - t0) * 1e3, 3),
            })
        for c in list(trace.root.children):
            if c.name != "fleet_hop":
                continue
            c1 = c.t1 if c.t1 is not None else now
            fleet_legs.append({
                "replica": str(c.attrs.get("replica", "")),
                "hop": str(c.attrs.get("hop", "")),
                "start_ms": round((c.t0 - t0) * 1e3, 3),
                "end_ms": round((c1 - t0) * 1e3, 3),
            })
    return {
        "request_id": request_id,
        "t0_wall": t0_wall,
        "fleet_legs": fleet_legs,
        "duration_ms": round(total_ms, 3),
        "finished": trace.finished if trace is not None else None,
        # Distinct engine generations this request's events span: one
        # plus observed restarts. seq_ids alone cannot tell (one agent
        # request legitimately wears one seq_id per llm turn).
        "engine_generations": restarts + 1,
        "engine_restarts": restarts,
        "seq_ids": sorted(seq_ids),
        "goodput": goodput,
        "phases": phases,
        "tool_overlap_ms": tool_overlap_ms,
        "overlap_windows": overlap_windows,
        "events": ev_out,
    }


# -- rendering ----------------------------------------------------------------
_BAR = "#"
_PAD = "."


def render_gantt(timeline: dict[str, Any], width: int = 64) -> str:
    """ASCII Gantt of a timeline dict (the `opsagent timeline` CLI body;
    pure string math so tests drive it without a terminal)."""
    total = max(1e-9, float(timeline.get("duration_ms", 0.0)))
    lines = [
        f"timeline {timeline.get('request_id', '?')}  "
        f"{total:.1f} ms total"
        + (
            f"  ({timeline['engine_generations']} engine generations)"
            if timeline.get("engine_generations", 1) > 1 else ""
        )
    ]
    g = timeline.get("goodput", {})
    if g:
        lines.append(
            "goodput: "
            + "  ".join(
                f"{p} {100.0 * g.get(p, 0.0):.1f}%"
                for p in (
                    "decode_active", "tool_blocked", "queued", "prefill",
                    "host",
                )
                if g.get(p)
            )
            + f"  (coverage {100.0 * g.get('coverage', 0.0):.1f}%)"
        )
    overlaps = timeline.get("overlap_windows") or []
    name_w = max(
        [len(p.get("phase", "")) for p in timeline.get("phases", [])]
        + ([len("tool_overlap")] if overlaps else [])
        + [5]
    )

    def _row(name: str, start_ms: float, end_ms: float, dur_ms: float,
             tag: str) -> str:
        a = int(round(start_ms / total * width))
        b = int(round(end_ms / total * width))
        b = min(width, max(b, a + 1))
        bar = _PAD * a + _BAR * (b - a) + _PAD * (width - b)
        return f"{name:<{name_w}s} |{bar}| {dur_ms:8.1f} ms{tag}"

    for seg in timeline.get("phases", []):
        attrs = seg.get("attrs") or {}
        tag = f" tool={attrs['tool']}" if attrs.get("tool") else ""
        lines.append(_row(
            seg["phase"], seg["start_ms"], seg["end_ms"],
            seg["duration_ms"], tag,
        ))
    # Conveyor windows: tool run time hidden under decode, drawn as extra
    # rows so the tool bar visibly overlaps the decode span above.
    for w in overlaps:
        tag = f" tool={w['tool']}" if w.get("tool") else ""
        lines.append(_row(
            "tool_overlap", w["start_ms"], w["end_ms"],
            w["duration_ms"], tag,
        ))
    if overlaps:
        lines.append(
            f"tool overlap hidden behind decode: "
            f"{timeline.get('tool_overlap_ms', 0.0):.1f} ms"
        )
    return "\n".join(lines)


# -- fleet stitching -----------------------------------------------------------
def _union_ms(spans: list[tuple[float, float]]) -> float:
    """Total length of the union of [a, b] intervals (units in == out)."""
    total = 0.0
    end = float("-inf")
    for a, b in sorted(spans):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def _lane_from_hops(
    hops: list[dict[str, Any]], wall: float
) -> str | None:
    """The replica of the latest router hop dispatched at or before
    ``wall`` — the time-partition fallback when a segment carries no
    replica tag of its own."""
    lane = None
    for h in sorted(hops, key=lambda h: h.get("wall", 0.0)):
        if h.get("replica") and h.get("wall", 0.0) <= wall + 1e-6:
            lane = h["replica"]
    if lane is None and hops:
        lane = hops[0].get("replica")
    return lane


def stitch_fleet(
    request_id: str,
    sources: dict[str, dict[str, Any]],
    journey: dict[str, Any] | None = None,
    offsets: dict[str, float] | None = None,
    reaped: list[str] | None = None,
    events: list[dict[str, Any]] | None = None,
) -> dict[str, Any]:
    """Merge per-replica ``assemble()`` timelines into one fleet journey.

    ``sources`` maps a replica id — or the sentinel ``"_shared"`` for an
    in-process fleet whose replicas share this process's trace store — to
    that replica's timeline dict. Remote segments are shifted onto the
    router's clock by subtracting ``offsets[replica]`` (replica wall
    MINUS router wall, registry.clock_offsets) before ordering, so two
    replicas' lanes interleave correctly even with skewed wall clocks;
    the ``"_shared"`` source is already on the router's clock and is
    split into lanes by its replica-tagged ``fleet_legs`` windows (hop
    time-partition as fallback). ``journey`` is the router's participants
    record (t0_wall / shape / replicas / hops), ``events`` the merged
    flight events already attributed to this request (router windows —
    failover, hedge, retry, fault-in — are derived from them), and
    ``reaped`` names participants the registry no longer knows: their
    segments are lost and the stitch degrades to the survivors, loudly.
    """
    offsets = offsets or {}
    journey = journey or {}
    events = events or []
    reaped = list(reaped or [])
    hops = list(journey.get("hops") or [])

    def _ev_wall(e: dict[str, Any]) -> float:
        return e.get("wall_corrected", e.get("wall", 0.0))

    # Per-source phase segments -> absolute router-frame wall seconds.
    raw: list[dict[str, Any]] = []
    for src, tl in sources.items():
        t0w = tl.get("t0_wall")
        if t0w is None:
            continue
        legs = sorted(
            tl.get("fleet_legs") or [], key=lambda g: g["start_ms"]
        )
        src_off = 0.0 if src == "_shared" else offsets.get(src, 0.0)
        for seg in tl.get("phases", []):
            mid = (seg["start_ms"] + seg["end_ms"]) / 2.0
            lane = None
            if src != "_shared":
                lane = src
            else:
                # Innermost (latest-starting) replica-tagged leg window
                # containing the segment midpoint: failover legs nest
                # inside the journey root's window, so the latest match
                # is the replica that actually ran this segment.
                for leg in legs:
                    if (
                        leg.get("replica")
                        and leg["start_ms"] - 1e-6 <= mid
                        <= leg["end_ms"] + 1e-6
                    ):
                        lane = leg["replica"]
                if lane is None:
                    lane = _lane_from_hops(hops, t0w + mid / 1e3)
            raw.append({
                "replica": lane or "?",
                "phase": seg["phase"],
                "a": t0w + seg["start_ms"] / 1e3 - src_off,
                "b": t0w + seg["end_ms"] / 1e3 - src_off,
                **(
                    {"attrs": seg["attrs"]} if seg.get("attrs") else {}
                ),
            })

    # Router-side windows from the journey's flight events: what the
    # replicas' own lanes can never show (the gap between a dying leg
    # and its failover re-dispatch, hedge launches, peer fault-in
    # fetch windows, the routing interval before the first dispatch).
    windows: list[dict[str, Any]] = []
    evs = sorted(events, key=_ev_wall)
    hop_walls = sorted(h.get("wall", 0.0) for h in hops)

    def _next_hop_after(w: float) -> float | None:
        for hw in hop_walls:
            if hw > w:
                return hw
        return None

    jt0 = journey.get("t0_wall")
    if jt0 is not None and hop_walls:
        windows.append({
            "kind": "routing", "a": jt0, "b": max(jt0, hop_walls[0]),
        })
    open_fault: list[dict[str, Any]] = []
    for e in evs:
        k, w = e.get("kind"), _ev_wall(e)
        if k == "failover":
            nxt = _next_hop_after(w)
            windows.append({
                "kind": "failover", "a": w,
                "b": nxt if nxt is not None else w,
                "replica": e.get("replica"),
            })
        elif k == "fleet_retry":
            nxt = _next_hop_after(w)
            windows.append({
                "kind": "retry", "a": w,
                "b": nxt if nxt is not None else w,
                "replica": e.get("replica"),
            })
        elif k == "fleet_hedge":
            windows.append({
                "kind": "hedge", "a": w, "b": w,
                "primary": e.get("primary"), "backup": e.get("backup"),
            })
        elif k == "page_fault_in":
            if e.get("phase") == "enter":
                open_fault.append(e)
            elif e.get("phase") == "exit" and open_fault:
                ent = open_fault.pop()
                windows.append({
                    "kind": "fault_in", "a": _ev_wall(ent), "b": w,
                    "replica": e.get("replica"),
                    "outcome": e.get("outcome"),
                    "pages": e.get("pages", 0),
                })

    anchors = [s["a"] for s in raw] + [w["a"] for w in windows]
    ends = [s["b"] for s in raw] + [w["b"] for w in windows]
    if jt0 is not None and (anchors or ends):
        anchors.append(jt0)
    if not anchors:
        return {
            "request_id": request_id, "fleet": True,
            "shape": journey.get("shape", "direct"),
            "replicas": [], "reaped": reaped, "clock_offset_ms": {},
            "t0_wall": jt0, "duration_ms": 0.0,
            "goodput": {"coverage": 0.0}, "coverage": 0.0,
            "lanes": {}, "segments": [], "windows": [], "events": [],
        }
    T0 = min(anchors)
    T1 = max(ends) if ends else T0
    total_ms = max(1e-9, (T1 - T0) * 1e3)

    def _rel(x: float) -> float:
        return round((x - T0) * 1e3, 3)

    ordered = sorted(raw, key=lambda s: (s["a"], s["b"]))
    lanes: dict[str, list[dict[str, Any]]] = {}
    for s in ordered:
        seg = {
            "replica": s["replica"], "phase": s["phase"],
            "start_ms": _rel(s["a"]), "end_ms": _rel(s["b"]),
            "duration_ms": round((s["b"] - s["a"]) * 1e3, 3),
        }
        if "attrs" in s:
            seg["attrs"] = s["attrs"]
        lanes.setdefault(s["replica"], []).append(seg)

    # Flattened, monotonic, non-overlapping segment list: the stitched
    # cross-replica ordering. Residual overlaps (clock-offset estimate
    # jitter, or a hedge loser's concurrent probe) clamp to the previous
    # segment's end; a fully-swallowed segment drops out.
    flat: list[dict[str, Any]] = []
    cursor = float("-inf")
    for s in ordered:
        a, b = max(s["a"], cursor), s["b"]
        if b - a <= 1e-9:
            continue
        flat.append({
            "replica": s["replica"], "phase": s["phase"],
            "start_ms": _rel(a), "end_ms": _rel(b),
            "duration_ms": round((b - a) * 1e3, 3),
        })
        cursor = b

    cov_union = _union_ms(
        [(s["a"], s["b"]) for s in raw]
        + [(w["a"], w["b"]) for w in windows]
    )
    coverage = (
        round(min(1.0, cov_union / (T1 - T0)), 4) if T1 > T0 else 1.0
    )
    by_phase: dict[str, float] = {}
    for s in flat:
        by_phase[s["phase"]] = (
            by_phase.get(s["phase"], 0.0) + s["duration_ms"]
        )
    goodput = {
        p: round(v / total_ms, 4) for p, v in sorted(by_phase.items())
    }
    goodput["coverage"] = coverage

    win_out = []
    for w in sorted(windows, key=lambda w: (w["a"], w["b"])):
        d = {k: v for k, v in w.items() if k not in ("a", "b")}
        d["start_ms"] = _rel(w["a"])
        d["end_ms"] = _rel(w["b"])
        d["duration_ms"] = round((w["b"] - w["a"]) * 1e3, 3)
        win_out.append(d)
    ev_out = []
    for e in evs:
        d = dict(e)
        d.pop("ts", None)
        d["t_ms"] = _rel(_ev_wall(e))
        ev_out.append(d)

    replicas = [
        r for r in (journey.get("replicas") or []) if r in lanes
    ]
    replicas += [r for r in lanes if r not in replicas]
    return {
        "request_id": request_id,
        "fleet": True,
        "shape": journey.get("shape", "direct"),
        "replicas": replicas,
        "reaped": reaped,
        "clock_offset_ms": {
            r: round(offsets.get(r, 0.0) * 1e3, 3) for r in replicas
        },
        "t0_wall": T0,
        "duration_ms": round(total_ms, 3),
        "goodput": goodput,
        "coverage": coverage,
        "lanes": lanes,
        "segments": flat,
        "windows": win_out,
        "events": ev_out,
    }


def render_fleet_gantt(stitched: dict[str, Any], width: int = 64) -> str:
    """ASCII multi-lane Gantt of a stitched fleet journey: one lane of
    rows per participating replica plus the router/fleet windows, all on
    one shared (skew-corrected) time axis."""
    total = max(1e-9, float(stitched.get("duration_ms", 0.0)))
    replicas = stitched.get("replicas") or []
    lines = [
        f"fleet journey {stitched.get('request_id', '?')}  "
        f"{total:.1f} ms total  shape={stitched.get('shape', 'direct')}  "
        f"replicas={len(replicas)}"
    ]
    reaped = stitched.get("reaped") or []
    if reaped:
        lines.append(
            "degraded: participant(s) reaped, segments lost: "
            + ", ".join(reaped)
        )
    offs = stitched.get("clock_offset_ms") or {}
    if any(offs.values()):
        lines.append(
            "clock offsets vs router: "
            + "  ".join(f"{r} {v:+.3f} ms" for r, v in offs.items())
        )
    g = stitched.get("goodput", {})
    if g:
        lines.append(
            "goodput: "
            + "  ".join(
                f"{p} {100.0 * v:.1f}%"
                for p, v in g.items() if p != "coverage" and v
            )
            + f"  (coverage {100.0 * g.get('coverage', 0.0):.1f}%)"
        )
    lanes = stitched.get("lanes") or {}
    windows = stitched.get("windows") or []
    name_w = max(
        [len(s["phase"]) for segs in lanes.values() for s in segs]
        + [len(w["kind"]) for w in windows] + [5]
    )

    def _row(name: str, start_ms: float, end_ms: float, dur_ms: float,
             tag: str = "") -> str:
        a = int(round(start_ms / total * width))
        b = int(round(end_ms / total * width))
        b = min(width, max(b, a + 1))
        bar = _PAD * a + _BAR * (b - a) + _PAD * (width - b)
        return f"  {name:<{name_w}s} |{bar}| {dur_ms:8.1f} ms{tag}"

    for r in replicas:
        lines.append(f"lane {r}:")
        for seg in lanes.get(r, []):
            lines.append(_row(
                seg["phase"], seg["start_ms"], seg["end_ms"],
                seg["duration_ms"],
            ))
    if windows:
        lines.append("router/fleet windows:")
        for w in windows:
            tag = ""
            if w.get("replica"):
                tag = f" replica={w['replica']}"
            if w["kind"] == "fault_in" and w.get("pages") is not None:
                tag += f" pages={w['pages']}"
            lines.append(_row(
                w["kind"], w["start_ms"], w["end_ms"],
                w["duration_ms"], tag,
            ))
    return "\n".join(lines)
