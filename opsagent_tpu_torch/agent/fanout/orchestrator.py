"""Fan-out/reduce audit orchestrator: plan -> scatter -> reduce (the port's
counterpart of ``opsagent_tpu/agent/fanout/orchestrator.py``, the same
plan, children, accounting and report bytes).

One audit request over an N-resource cluster becomes N batch-class child
sessions through the fleet router, then one deterministic report:

- **plan**: shard the cluster inventory into per-resource work items that
  all share one system-prompt + cluster-context prefix. The shared token
  prefix is measured once (page-aligned, the unit the KV trie matches)
  and becomes the denominator of the fan-out's prefix-hit accounting.
- **scatter**: prime each live decode replica with one prefix-bearing
  request so the shared pages are trie-resident BEFORE the admission
  wave (the no-thundering-herd guarantee: without it, N simultaneous
  admissions each re-prefill the same prefix), then submit the children
  as ``slo_class="batch"`` sessions with bounded in-flight concurrency.
  Each child launches its probe (``kubectl describe``-shaped evidence
  from the synthetic cluster) the moment its completion is dispatched —
  the Conveyor overlap, probe latency hidden behind the child's decode —
  and decodes schema-constrained findings JSON so grammar fast-forward
  eats the structural tokens.
- **reduce**: merge per-child findings with a stable
  ``(severity, resource, issue)`` sort into one report whose canonical
  JSON form is byte-identical across runs. Failure containment is
  per-child: a child that stays shed/failed after bounded retries
  becomes a ``finding_unavailable`` row — an audit is never silently
  missing a resource.

The accounting deliberately reads COUNTER DELTAS (prefix-hit tokens),
not flight-ring events: flood-control sampling of high-volume flight
kinds during the admission wave must not be able to corrupt the
fan-out's own numbers.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from typing import Any

from ... import obs
from .synthcluster import SynthCluster, detect_findings, severity_rank

# Schema the children decode under (grammar ffwd forces the structure;
# only the value bytes cost forward passes).
FINDING_SCHEMA = {
    "type": "object",
    "properties": {
        "resource": {"type": "string"},
        "status": {"type": "string"},
    },
    "required": ["resource", "status"],
}

_SYSTEM_TEMPLATE = (
    "You are OpsAgent, auditing a Kubernetes cluster for operational "
    "risk. {inventory} Inspect the assigned resource with the probe "
    "evidence and report its status as JSON."
)


@dataclass
class FanoutConfig:
    """Knobs of one fan-out run. Defaults suit in-process test fleets;
    the CLI overrides sizes from its own flags."""

    max_inflight: int = 8        # bounded scatter concurrency (the gate)
    max_tokens: int = 16         # per-child decode budget
    retries: int = 2             # per-child re-submissions before giving up
    retry_backoff_s: float = 0.05
    prime: bool = True           # pre-warm the shared prefix per replica
    constrained: bool = True     # schema-constrained findings decode
    probe_overlap: bool = True   # Conveyor-style probe launch at dispatch
    flight_sample: int = 0       # >1: sample admission/dispatch flight
    # kinds at 1-in-N while the wave is in flight (flood control)


@dataclass
class FanoutReport:
    """One finished fan-out. ``report``/``canonical`` are deterministic
    (byte-identical across runs of the same cluster); ``stats`` carries
    the run's timings and serving-side accounting and is not."""

    fanout_id: str
    report: dict[str, Any]
    canonical: str
    stats: dict[str, Any] = field(default_factory=dict)

    @property
    def findings(self) -> list[dict[str, Any]]:
        return self.report["findings"]

    def recall(self, cluster: SynthCluster) -> float:
        """Fraction of injected issues present in the reduced report."""
        truth = {
            (f["resource"], f["issue"]) for f in cluster.ground_truth()
        }
        if not truth:
            return 1.0
        got = {(f["resource"], f["issue"]) for f in self.findings}
        return len(truth & got) / len(truth)


# Process-wide active-fan-out accounting behind the obs gauges (top's
# fan-out row reads these through the history sampler).
_active_lock = threading.Lock()
_active = 0


def _set_active(delta: int) -> None:
    global _active
    with _active_lock:
        _active = max(0, _active + delta)
        obs.FANOUT_ACTIVE.set(float(_active))


def _child_body(
    system: str, resource: str, fanout_id: str, cfg: FanoutConfig,
) -> dict[str, Any]:
    body: dict[str, Any] = {
        "messages": [
            {"role": "system", "content": system},
            {
                "role": "user",
                "content": f"Audit resource {resource}.",
            },
        ],
        "max_tokens": cfg.max_tokens,
        "temperature": 0.0,
        "slo_class": "batch",
        "fanout_id": fanout_id,
    }
    if cfg.constrained:
        body["response_format"] = {
            "type": "json_schema",
            "json_schema": {"name": "finding", "schema": FINDING_SCHEMA},
        }
    return body


def _shared_prefix_tokens(
    router: Any, bodies: list[dict[str, Any]],
) -> tuple[int, int]:
    """(aligned_tokens, page_size) of the prompt prefix every child
    shares, measured the way the KV trie matches it: the common token
    prefix of two child prompts, rounded DOWN to full pages of the
    smallest live page size (a partial page never hits)."""
    page = 0
    for info in router.registry.alive(role="decode"):
        page = min(page, info.page_size) if page else info.page_size
    if len(bodies) < 2 or page <= 0:
        return 0, max(1, page)
    a = router.tokenize(bodies[0]) or []
    b = router.tokenize(bodies[1]) or []
    common = 0
    for x, y in zip(a, b):
        if x != y:
            break
        common += 1
    # The engine matches prompt_ids[:n-1] (the last token is always
    # decoded), so the shareable span is bounded by the shorter prompt
    # minus one.
    common = min(common, max(0, len(a) - 1), max(0, len(b) - 1))
    return (common // page) * page, page


def run_audit(
    router: Any,
    cluster: SynthCluster,
    cfg: FanoutConfig | None = None,
) -> FanoutReport:
    """Run one fan-out audit over ``cluster`` through ``router``.
    Blocking; safe to call from any thread."""
    cfg = cfg or FanoutConfig()
    fanout_id = obs.new_request_id("fanout")
    system = _SYSTEM_TEMPLATE.format(inventory=cluster.inventory_text())
    items = cluster.work_items()
    bodies = [_child_body(system, r, fanout_id, cfg) for r in items]
    aligned, page = _shared_prefix_tokens(router, bodies)
    obs.flight.record(
        "fanout_plan", fanout_id=fanout_id, children=len(items),
        shared_prefix_tokens=aligned, page_size=page,
    )
    obs.FANOUT_CHILDREN_TOTAL.set(float(len(items)))
    obs.FANOUT_CHILDREN_DONE.set(0.0)
    _set_active(+1)
    rec = obs.flight.get_recorder()
    sampled_kinds = ("admission", "dispatch", "ttft", "route_decision")
    if cfg.flight_sample > 1:
        for kind in sampled_kinds:
            rec.set_sample_rate(kind, cfg.flight_sample)
    t0 = time.perf_counter()
    try:
        if cfg.prime:
            primes = _prime_replicas(router, system, fanout_id, cfg)
        else:
            primes = 0
        hits0 = obs.PREFIX_HIT_TOKENS.value()
        t_scatter = time.perf_counter()
        results = _scatter(router, items, bodies, cluster, cfg)
        scatter_s = time.perf_counter() - t_scatter
        hit_tokens = obs.PREFIX_HIT_TOKENS.value() - hits0
    finally:
        if cfg.flight_sample > 1:
            for kind in sampled_kinds:
                rec.set_sample_rate(kind, 0)
        _set_active(-1)

    # -- reduce -------------------------------------------------------------
    t_reduce = time.perf_counter()
    rows: list[dict[str, Any]] = []
    outcomes = {"ok": 0, "shed": 0, "failed": 0}
    for r in results:
        outcomes[r["outcome"]] = outcomes.get(r["outcome"], 0) + 1
        if r["outcome"] == "ok":
            rows.extend(r["findings"])
        else:
            # Failure containment: the resource stays in the report.
            rows.append({
                "resource": r["resource"],
                "issue": "finding_unavailable",
                "severity": "unavailable",
                "detail": f"child {r['outcome']}",
            })
    rows.sort(key=lambda f: (
        severity_rank(f["severity"]), f["resource"], f["issue"],
    ))
    by_severity: dict[str, int] = {}
    for f in rows:
        by_severity[f["severity"]] = by_severity.get(f["severity"], 0) + 1
    report = {
        "cluster": {
            "name": f"synth-{cluster.seed}",
            "resources": len(items),
            "seed": cluster.seed,
        },
        "findings": rows,
        "summary": {
            "resources": len(items),
            "audited": outcomes.get("ok", 0),
            "unavailable": len(items) - outcomes.get("ok", 0),
            "findings": sum(
                n for s, n in by_severity.items() if s != "unavailable"
            ),
            "by_severity": by_severity,
        },
    }
    canonical = json.dumps(
        report, sort_keys=True, separators=(",", ":"), ensure_ascii=False,
    )
    reduce_s = time.perf_counter() - t_reduce
    total_s = time.perf_counter() - t0

    # -- per-fan-out accounting --------------------------------------------
    n = len(items)
    denom = n * aligned
    hit_rate = min(1.0, hit_tokens / denom) if denom else 0.0
    avoided_children = (
        min(n, int(hit_tokens // aligned)) if aligned else 0
    )
    for outcome, count in outcomes.items():
        if count:
            obs.FANOUT_CHILDREN.inc(count, outcome=outcome)
    for severity, count in by_severity.items():
        obs.FANOUT_FINDINGS.inc(count, severity=severity)
    if hit_tokens > 0:
        obs.FANOUT_REPREFILL_AVOIDED.inc(hit_tokens)
    obs.FANOUT_REDUCE_SECONDS.observe(reduce_s)
    obs.FANOUT_PREFIX_HIT_RATE.set(hit_rate)
    obs.flight.record(
        "fanout_reduce", fanout_id=fanout_id, children=n,
        findings=len(rows), reduce_s=round(reduce_s, 4),
        audit_s=round(total_s, 4), prefix_hit_rate=round(hit_rate, 4),
        avoided_children=avoided_children, outcomes=outcomes,
    )
    stats = {
        "fanout_id": fanout_id,
        "children": n,
        "outcomes": outcomes,
        "primes": primes,
        "audit_s": total_s,
        "scatter_s": scatter_s,
        "reduce_s": reduce_s,
        "shared_prefix_tokens": aligned,
        "prefix_hit_tokens": int(hit_tokens),
        "prefix_hit_rate": hit_rate,
        "avoided_children": avoided_children,
    }
    return FanoutReport(
        fanout_id=fanout_id, report=report, canonical=canonical,
        stats=stats,
    )


def _prime_replicas(
    router: Any, system: str, fanout_id: str, cfg: FanoutConfig,
) -> int:
    """Land the shared prefix on every live decode replica before the
    wave: one forced single-token request per replica inserts the prefix
    pages into that replica's trie, so child #1..N all hit instead of
    racing to re-prefill it N times (and the pagestore directory learns
    an owner for cross-replica fault-in)."""
    primed = 0
    for info in router.registry.alive(role="decode"):
        body = {
            "messages": [
                {"role": "system", "content": system},
                {"role": "user", "content": "Audit resource warmup."},
            ],
            "max_tokens": 1,
            "temperature": 0.0,
            "slo_class": "batch",
            "fanout_id": fanout_id,
        }
        try:
            router.complete(body, force_replica=info.replica_id)
            primed += 1
        except Exception:  # noqa: BLE001 - priming is an optimization
            obs.flight.record(
                "fanout_prime_failed", fanout_id=fanout_id,
                replica=info.replica_id,
            )
    return primed


def _scatter(
    router: Any,
    items: list[str],
    bodies: list[dict[str, Any]],
    cluster: SynthCluster,
    cfg: FanoutConfig,
) -> list[dict[str, Any]]:
    from concurrent.futures import ThreadPoolExecutor

    done_lock = threading.Lock()
    done = 0

    def child(idx: int) -> dict[str, Any]:
        nonlocal done
        resource = items[idx]
        body = bodies[idx]
        outcome = "failed"
        evidence = ""
        for attempt in range(cfg.retries + 1):
            probe: dict[str, Any] = {}
            probe_thread = None
            t_launch = time.perf_counter()
            if cfg.probe_overlap:
                # Conveyor at fleet granularity: the probe fires the
                # moment the completion is dispatched, so its latency
                # overlaps the child's decode instead of following it.
                def run_probe() -> None:
                    probe["evidence"] = cluster.describe(resource)
                    probe["t_end"] = time.perf_counter()

                probe_thread = threading.Thread(
                    target=run_probe, daemon=True
                )
                obs.TOOL_EARLY_LAUNCHES.inc(tool="kubectl")
                probe_thread.start()
            try:
                router.complete(dict(body))
                outcome = "ok"
            except Exception as e:  # noqa: BLE001 - contained per child
                shed = getattr(e, "retry_after_s", None) is not None or \
                    type(e).__name__ == "OverloadError"
                outcome = "shed" if shed else "failed"
                if probe_thread is not None:
                    probe_thread.join()
                if attempt < cfg.retries:
                    time.sleep(cfg.retry_backoff_s * (attempt + 1))
                    continue
                break
            t_done = time.perf_counter()
            if probe_thread is not None:
                probe_thread.join()
                evidence = probe["evidence"]
                overlap = max(
                    0.0, min(probe["t_end"], t_done) - t_launch
                )
                obs.TOOL_OVERLAP_SECONDS.inc(overlap)
            else:
                evidence = cluster.describe(resource)
            break
        with done_lock:
            done += 1
            obs.FANOUT_CHILDREN_DONE.set(float(done))
        findings = (
            detect_findings(evidence, resource) if outcome == "ok" else []
        )
        return {
            "resource": resource,
            "outcome": outcome,
            "findings": findings,
        }

    workers = max(1, int(cfg.max_inflight))
    with ThreadPoolExecutor(max_workers=workers) as ex:
        return list(ex.map(child, range(len(items))))
