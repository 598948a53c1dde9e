"""Serving observability (the port's copy of ``opsagent_tpu/obs``):
Prometheus ``/metrics`` exposition, per-request trace spans, and the shared
instrument handles the engine/scheduler/server layers record into.

Import surface:

- ``get_registry()`` / ``metrics_text()`` / ``metrics_snapshot()`` — the
  process-wide metrics registry and its exposition/snapshot forms.
- ``trace_request`` / ``span`` / ``current_span`` / ``get_trace`` — the
  per-request span-tree API (obs/trace.py).
- Module-level instrument handles (``TTFT_SECONDS`` etc.) — created once
  at import; every layer records into the same child samples.

The instrument names are the contract ``docs/observability.md`` documents;
renaming one is a dashboard-breaking change. The port declares every family
the JAX package declares, those of the layers it has not ported yet
included, so both packages' scrapes carry the same families. Only the HELP
text of the compile family differs: in the port a "compile" is a CUDA-graph
capture (``serving/decode_graph.py``) or an ``nvcc`` build
(``ops/cuda_build.py``), both reported through ``flight.on_compile``.
"""

from __future__ import annotations

from .metrics import (  # noqa: F401
    DEFAULT_TIME_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    Registry,
    escape_label_value,
    get_registry,
)
from .trace import (  # noqa: F401
    Span,
    Trace,
    current_span,
    format_tree,
    get_store,
    get_trace,
    new_request_id,
    span,
    trace_request,
)

_reg = get_registry()

# -- flight recorder + compile watchdog + SLO watchdog ------------------------
COMPILES = _reg.counter(
    "opsagent_xla_compiles_total",
    "Device-program builds by phase (startup/warmup/serving): CUDA-graph "
    "captures of the serving steps and nvcc kernel builds; phase=serving "
    "after a completed warmup is the anomaly",
    labelnames=("phase",),
)
COMPILE_SECONDS = _reg.histogram(
    "opsagent_xla_compile_seconds",
    "Wall time of one CUDA-graph capture or nvcc kernel build, by phase",
    labelnames=("phase",),
    buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
             60.0, 120.0),
)
POST_WARMUP_COMPILES = _reg.gauge(
    "opsagent_post_warmup_compiles",
    "CUDA-graph captures and nvcc builds AFTER a completed warmup — the "
    "live form of the zero-post-warmup-compiles invariant (healthy "
    "value: 0)",
)
# Materialize the healthy value: an absent gauge and "zero anomalous
# compiles" must not look the same on a scrape.
POST_WARMUP_COMPILES.set(0.0)
COMPILE_CACHE_EVENTS = _reg.counter(
    "opsagent_compile_cache_events_total",
    "Kernel build cache events: cache_hits = a kernel library already "
    "built from this source, cache_misses = nvcc ran",
    labelnames=("event",),
)
ANOMALIES = _reg.counter(
    "opsagent_anomalies_total",
    "Flight-recorder anomaly triggers by reason (each one dumps the "
    "event ring to JSONL, rate-limited)",
    labelnames=("reason",),
)

# -- engine step telemetry ----------------------------------------------------
TTFT_SECONDS = _reg.histogram(
    "opsagent_ttft_seconds",
    "Time to first token per admitted request (admission to first sample)",
    buckets=(0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
             10.0, 30.0, 60.0),
)
ITL_SECONDS = _reg.histogram(
    "opsagent_inter_token_latency_seconds",
    "Latency between consecutive accepted tokens of one sequence",
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
             0.25, 0.5, 1.0, 2.5),
)
DECODE_TOKENS = _reg.counter(
    "opsagent_decode_tokens_total", "Tokens produced by decode steps"
)
PREFILL_TOKENS = _reg.counter(
    "opsagent_prefill_tokens_total", "Prompt tokens prefilled (cache misses)"
)
PREFIX_HIT_TOKENS = _reg.counter(
    "opsagent_prefix_hit_tokens_total",
    "Prompt tokens served from the prefix cache instead of prefill",
)
DECODE_DISPATCHES = _reg.counter(
    "opsagent_decode_dispatches_total",
    "Device decode dispatches by kind (block, single, speculative, mixed)",
    labelnames=("kind",),
)
MIXED_DECODE_LANES = _reg.histogram(
    "opsagent_mixed_dispatch_decode_lanes",
    "Decode lanes advanced per mixed prefill+decode dispatch",
    buckets=(0, 1, 2, 4, 8, 16, 32, 64),
)
MIXED_PREFILL_TOKENS = _reg.histogram(
    "opsagent_mixed_dispatch_prefill_tokens",
    "Prefill chunk tokens piggybacked per mixed dispatch's weight stream",
    buckets=(0, 8, 16, 32, 64, 128, 256, 512),
)
MIXED_BUDGET_UTILIZATION = _reg.histogram(
    "opsagent_mixed_step_budget_utilization",
    "Fraction of max_step_tokens used per mixed dispatch (0..1)",
    buckets=(0.1, 0.25, 0.5, 0.75, 0.9, 1.0),
)
# -- async mixed serving runtime (serving/async_runtime.py) -------------------
STEP_HOST_GAP_SECONDS = _reg.histogram(
    "opsagent_step_host_gap_seconds",
    "Host-side gap between consecutive mixed-tick device dispatches "
    "(enqueue-return to next enqueue — time the device can go idle "
    "waiting on host work), by tick mode (sync = async_depth 1, "
    "async = one-step-lookahead pipeline)",
    labelnames=("mode",),
    buckets=(0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
             0.025, 0.05, 0.1, 0.25, 1.0),
)
ASYNC_INFLIGHT_DEPTH = _reg.gauge(
    "opsagent_async_inflight_depth",
    "Mixed-tick dispatches currently in flight (dispatched, uncommitted)",
)
ASYNC_COMMITS = _reg.counter(
    "opsagent_async_commits_total",
    "Async mixed ticks committed (token pull + host post-processing)",
)
ASYNC_OVERLAPPED_COMMITS = _reg.counter(
    "opsagent_async_overlapped_commits_total",
    "Commits whose host work ran while a newer dispatch was still in "
    "flight on device — the overlap the async runtime exists for",
)
ASYNC_OVERSHOOT_TOKENS = _reg.counter(
    "opsagent_async_overshoot_tokens_total",
    "Lookahead tokens discarded because their row had already finished "
    "(stop/EOS detection lags one tick; the page booking is rolled back)",
)
ASYNC_FALLBACKS = _reg.counter(
    "opsagent_async_fallbacks_total",
    "Async mixed ticks that settled the pipeline and fell back to a "
    "sync lane, by reason (hosted / fsm_mismatch / carry_break / "
    "ffwd_ineligible = constrained row that cannot fast-forward: "
    "hosted mask, no dense tables, or logprobs requested)",
    labelnames=("reason",),
)

FFWD_TOKENS = _reg.counter(
    "opsagent_ffwd_tokens_total",
    "Tokens emitted by grammar fast-forward (singleton-mask FSM states) "
    "without a per-token forward pass",
)
FFWD_RUNS = _reg.counter(
    "opsagent_ffwd_runs_total",
    "Forced-token runs spliced as multi-token appends by the grammar "
    "fast-forward path",
)
FFWD_SKIPPED_DISPATCHES = _reg.counter(
    "opsagent_ffwd_skipped_dispatches_total",
    "Decode dispatches the grammar fast-forward made unnecessary (one "
    "per forced token: that token would otherwise have cost a full "
    "forward pass)",
)

KV_PAGE_UTILIZATION = _reg.gauge(
    "opsagent_kv_page_utilization",
    "Fraction of KV-cache pages in use (0..1)",
)
KV_PAGES_FREE = _reg.gauge(
    "opsagent_kv_pages_free", "KV-cache pages currently free"
)
BATCH_OCCUPANCY = _reg.gauge(
    "opsagent_batch_occupancy",
    "Running decode sequences over max_batch_size (0..1)",
)
RUNNING_SEQUENCES = _reg.gauge(
    "opsagent_running_sequences", "Sequences the engine currently tracks"
)
PREEMPTIONS = _reg.counter(
    "opsagent_preemptions_total",
    "Sequences force-finished because the KV page budget ran out",
)
PREFIX_EVICTIONS = _reg.counter(
    "opsagent_prefix_evictions_total", "Prefix-cache trie leaf evictions"
)

# -- hierarchical KV cache: host-RAM offload tier -----------------------------
OFFLOAD_PAGES = _reg.counter(
    "opsagent_offload_pages_total",
    "KV pages moved between HBM and the host pool, by direction "
    "(out = device->host spill, in = host->device restore)",
    labelnames=("dir",),
)
OFFLOAD_BYTES = _reg.counter(
    "opsagent_offload_bytes_total",
    "Bytes moved between HBM and the host pool, by direction",
    labelnames=("dir",),
)
OFFLOAD_PARKS = _reg.counter(
    "opsagent_offload_parks_total",
    "Session parking events by trigger (tool = ReAct tool-exec window, "
    "pressure = admission-pressure eviction of a cold session)",
    labelnames=("trigger",),
)
OFFLOAD_RESTORE_SECONDS = _reg.histogram(
    "opsagent_offload_restore_seconds",
    "Host->device KV restore latency per admission (copy, not re-prefill)",
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
             0.25, 0.5, 1.0, 2.5),
)
OFFLOAD_REPREFILL_AVOIDED = _reg.counter(
    "opsagent_offload_reprefill_avoided_tokens_total",
    "Prompt tokens restored from the host pool instead of re-prefilled",
)
OFFLOAD_RESTORE_FALLBACKS = _reg.counter(
    "opsagent_offload_restore_fallbacks_total",
    "Parked-session admissions that fell back to re-prefill because the "
    "host pool had dropped their pages (each is a flight-ring anomaly)",
)
HOST_POOL_BYTES = _reg.gauge(
    "opsagent_kv_host_pool_bytes", "Host-RAM KV pool bytes resident"
)
HOST_POOL_CAPACITY = _reg.gauge(
    "opsagent_kv_host_pool_capacity_bytes",
    "Host-RAM KV pool byte bound (OPSAGENT_KV_HOST_POOL_BYTES)",
)
HOST_POOL_PAGES = _reg.gauge(
    "opsagent_kv_host_pool_pages", "Host-RAM KV pool pages resident"
)
HOST_POOL_DROPS = _reg.counter(
    "opsagent_kv_host_pool_drops_total",
    "Host-pool pages LRU-dropped under the byte bound",
)

# -- fleet serving: replica router + session migration (serving/fleet) --------
FLEET_REPLICAS = _reg.gauge(
    "opsagent_fleet_replicas",
    "Registered engine replicas by role (decode/prefill) and state "
    "(active/draining)",
    labelnames=("role", "state"),
)
FLEET_ROUTE_DECISIONS = _reg.counter(
    "opsagent_fleet_route_decisions_total",
    "Router placement decisions by winning policy (pinned = sticky "
    "session->replica map, affinity = longest-cached-prefix over the "
    "replica trie digests, least_loaded = goodput/queue fallback, "
    "spill = pinned/affinity replica over its queue bound, forced = "
    "operator/test override, prefill = disaggregated prefill lane)",
    labelnames=("policy",),
)
FLEET_AFFINITY_PAGES = _reg.histogram(
    "opsagent_fleet_affinity_hit_pages",
    "Cached-prefix pages the chosen replica already held for the routed "
    "prompt (the re-prefill the placement avoided, in pages)",
    buckets=(0, 1, 2, 4, 8, 16, 32, 64, 128),
)
FLEET_MIGRATIONS = _reg.counter(
    "opsagent_fleet_session_migrations_total",
    "Session migrations over the KV-page transfer path, by reason "
    "(misroute = affinity miss onto a replica without the pages, "
    "drain = graceful replica drain, prefill_handoff = disaggregated "
    "prefill lane -> decode replica)",
    labelnames=("reason",),
)
FLEET_TRANSFER_PAGES = _reg.counter(
    "opsagent_fleet_kv_transfer_pages_total",
    "KV pages shipped replica-to-replica (host-pool chain entries)",
)
FLEET_TRANSFER_BYTES = _reg.counter(
    "opsagent_fleet_kv_transfer_bytes_total",
    "Bytes of KV page payload shipped replica-to-replica",
)
FLEET_TRANSFER_SECONDS = _reg.histogram(
    "opsagent_fleet_kv_transfer_seconds",
    "Wall time of one replica-to-replica chain transfer (export + import)",
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
             1.0, 2.5),
)
FLEET_SPILLOVERS = _reg.counter(
    "opsagent_fleet_queue_spillovers_total",
    "Routes bounced off a preferred replica because its queue depth "
    "exceeded the spill bound",
)
FLEET_REQUESTS = _reg.counter(
    "opsagent_fleet_requests_total",
    "Requests routed through the fleet front-end by outcome "
    "(completed / error / shed)",
    labelnames=("outcome",),
)

# -- failure containment: fault injection, failover, shedding -----------------
FAULT_INJECTIONS = _reg.counter(
    "opsagent_fault_injections_total",
    "Deterministic fault injections fired, by fault point "
    "(serving/faults.py; OPSAGENT_FAULTS spec)",
    labelnames=("point",),
)
FLEET_FAILOVERS = _reg.counter(
    "opsagent_fleet_failovers_total",
    "Mid-request failovers: a request re-submitted to a surviving "
    "replica after its serving replica failed (streams resume from the "
    "last emitted offset, dedup on re-submit)",
)
FLEET_RETRIES = _reg.counter(
    "opsagent_fleet_retries_total",
    "Bounded connect-phase retries against fleet replicas "
    "(exponential backoff + jitter)",
)
FLEET_HEDGES = _reg.counter(
    "opsagent_fleet_hedges_total",
    "TTFT hedges: a queued cold admission raced on a second replica, "
    "first completion wins; labeled by the request's SLO class",
    labelnames=("class",),
)
FLEET_EJECTIONS = _reg.counter(
    "opsagent_fleet_ejections_total",
    "Circuit-breaker ejections (replica health healthy -> suspect -> "
    "ejected; half-open probes readmit)",
)
FLEET_SHED = _reg.counter(
    "opsagent_fleet_shed_total",
    "Requests shed by router admission control above the overload "
    "watermark (429 + Retry-After), by SLO class of the shed request",
    labelnames=("class",),
)
FLEET_REPLICA_HEALTH = _reg.gauge(
    "opsagent_fleet_replica_health",
    "Registered replicas by circuit-breaker health state",
    labelnames=("state",),
)
FLEET_KV_IMPORT_REJECTS = _reg.counter(
    "opsagent_fleet_kv_import_rejects_total",
    "KV transfer records rejected at import (payload digest or "
    "structure mismatch); the receiver re-prefills instead",
)

# -- fleet request journeys: cross-replica trace propagation ------------------
FLEET_HOP_SECONDS = _reg.histogram(
    "opsagent_fleet_hop_seconds",
    "Wall time of one replica hop of a routed request, by hop kind "
    "(route = non-streaming completion, stream = streaming completion, "
    "failover = mid-SSE resume on a survivor, hedge = TTFT hedge probe, "
    "prefill = disaggregated prefill handoff, fault_in = pagestore peer "
    "fetch, migrate = session KV migration)",
    labelnames=("hop",),
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
             1.0, 2.5, 5.0, 10.0, 30.0),
)
FLEET_JOURNEYS = _reg.counter(
    "opsagent_fleet_journeys_total",
    "Completed fleet request journeys by shape (direct = one replica "
    "start to finish, retried = connect-phase re-route, hedged = a "
    "backup probe raced, failover = resumed on a survivor mid-request; "
    "a journey counts once under its most eventful shape), by shape "
    "and SLO class",
    labelnames=("shape", "class"),
)
FLEET_CLOCK_SKEW = _reg.gauge(
    "opsagent_fleet_clock_skew_seconds",
    "EWMA estimate of a replica's wall clock minus the router's wall "
    "clock, from heartbeat timestamp echoes (the offset the fleet "
    "timeline stitcher subtracts before ordering cross-replica "
    "segments)",
    labelnames=("replica",),
)

# -- fleet-global KV: page directory + peer-to-peer fault-in ------------------
PAGESTORE_LOOKUPS = _reg.counter(
    "opsagent_pagestore_lookups_total",
    "Chain-key lookups against the fleet page directory at admission "
    "(one per missing page-aligned prefix chain)",
)
PAGESTORE_REMOTE_HITS = _reg.counter(
    "opsagent_pagestore_remote_hits_total",
    "KV page chains faulted in peer-to-peer and landed in the local "
    "host pool (the remote tier between host-pool-hit and re-prefill)",
)
PAGESTORE_FETCH_BYTES = _reg.counter(
    "opsagent_pagestore_fetch_bytes_total",
    "Bytes of KV page payload fetched peer-to-peer by the page store",
)
PAGESTORE_FETCH_SECONDS = _reg.histogram(
    "opsagent_pagestore_fetch_seconds",
    "Wall time of one admission page fault-in (directory lookup "
    "excluded; fetch + verify + host-pool landing)",
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
             1.0, 2.5, 5.0),
)
PAGESTORE_STALE_ENTRIES = _reg.counter(
    "opsagent_pagestore_stale_entries_total",
    "Directory rows evicted because the advertised peer could not "
    "produce the chain (LRU-evicted between heartbeats, 404, or "
    "digest reject)",
)
PAGESTORE_FALLBACKS = _reg.counter(
    "opsagent_pagestore_fallbacks_total",
    "Admissions that degraded to local re-prefill after a page-store "
    "attempt, by reason (no_owner / miss / timeout / error / "
    "lookup_error)",
    labelnames=("reason",),
)

# -- cold start: engine snapshot/restore + elastic autoscaling ----------------
SNAPSHOT_OPS = _reg.counter(
    "opsagent_snapshot_ops_total",
    "Engine snapshot operations by kind (write = snapshot created, "
    "restore = engine restored, refused = fingerprint/device/leaf-order "
    "mismatch rejected)",
    labelnames=("op",),
)
SNAPSHOT_WRITE_SECONDS = _reg.histogram(
    "opsagent_snapshot_write_seconds",
    "Wall time to write one engine snapshot (weights device_get + leaf "
    "files + compile-cache copy + manifest)",
    buckets=(0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0),
)
SNAPSHOT_RESTORE_SECONDS = _reg.histogram(
    "opsagent_snapshot_restore_seconds",
    "Wall time from reading a snapshot manifest to a request-ready "
    "engine (mmap + device_put + cache-hit warmup sweep)",
    buckets=(0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0),
)
SNAPSHOT_BYTES = _reg.gauge(
    "opsagent_snapshot_bytes",
    "Size of the last snapshot written, by part (weights / "
    "compile_cache)",
    labelnames=("part",),
)
FLEET_SCALE_EVENTS = _reg.counter(
    "opsagent_fleet_scale_events_total",
    "Autoscaler actions by direction (up = standby replica launched "
    "from the snapshot, promote = request-ready standby admitted to "
    "decode rotation, down = idle autoscaled replica drained)",
    labelnames=("direction",),
)

# -- request lifecycle --------------------------------------------------------
ENGINE_REQUESTS = _reg.counter(
    "opsagent_engine_requests_total",
    "Engine generation requests by outcome",
    labelnames=("outcome",),
)
QUEUE_WAIT_SECONDS = _reg.histogram(
    "opsagent_queue_wait_seconds",
    "Scheduler admission queue wait per request",
    buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0, 120.0),
)
HTTP_REQUESTS = _reg.counter(
    "opsagent_http_requests_total",
    "HTTP requests by method, path, and status",
    labelnames=("method", "path", "status"),
)
HTTP_LATENCY_SECONDS = _reg.histogram(
    "opsagent_http_request_duration_seconds",
    "HTTP request wall time by path",
    labelnames=("path",),
)
AGENT_ITERATIONS = _reg.counter(
    "opsagent_agent_iterations_total", "ReAct loop iterations"
)
TOOL_CALLS = _reg.counter(
    "opsagent_agent_tool_calls_total",
    "Agent tool invocations by tool and outcome",
    labelnames=("tool", "outcome"),
)
TOOL_OVERLAP_SECONDS = _reg.counter(
    "opsagent_tool_overlap_seconds_total",
    "Seconds of tool execution hidden behind decode by conveyor "
    "launches (launch to min(tool end, stream end))",
)
TOOL_EARLY_LAUNCHES = _reg.counter(
    "opsagent_tool_early_launches_total",
    "Conveyor tool launches fired mid-decode at readiness-close",
    labelnames=("tool",),
)
TOOL_LAUNCH_LEAD_SECONDS = _reg.histogram(
    "opsagent_tool_launch_lead_seconds",
    "Lead time a conveyor launch gained over the classic path "
    "(launch to stream end)",
    labelnames=("tool",),
    buckets=(0.005, 0.02, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0),
)

# -- SLO classes + telemetry history + trace retention ------------------------
# The class enum is closed: every request is exactly one of these, and
# the metrics-conformance cardinality guard rejects any other value on
# the scrape (free-form class labels would melt it like request ids).
SLO_CLASSES = ("interactive", "batch", "background")
CLASS_REQUESTS = _reg.counter(
    "opsagent_class_requests_total",
    "Requests by SLO class and outcome (completed / error / timeout / "
    "admission_failed / shed) — the per-class attainment numerator and "
    "denominator",
    labelnames=("class", "outcome"),
)
CLASS_TTFT_SECONDS = _reg.histogram(
    "opsagent_class_ttft_seconds",
    "Time to first token per admitted request, split by SLO class "
    "(the unlabeled opsagent_ttft_seconds stays the all-traffic view)",
    labelnames=("class",),
    buckets=(0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
             10.0, 30.0, 60.0),
)
CLASS_ITL_SECONDS = _reg.histogram(
    "opsagent_class_itl_seconds",
    "Inter-token latency split by SLO class",
    labelnames=("class",),
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
             0.25, 0.5, 1.0, 2.5),
)
CLASS_GOODPUT_SECONDS = _reg.counter(
    "opsagent_class_goodput_seconds_total",
    "Request wall seconds by SLO class and goodput phase (the per-class "
    "split of opsagent_goodput_seconds_total)",
    labelnames=("class", "phase"),
)
# -- audit fan-out: plan/scatter/reduce over the fleet (agent/fanout) ---------
FANOUT_CHILDREN = _reg.counter(
    "opsagent_fanout_children_total",
    "Fan-out child sessions by outcome (ok / shed / failed; shed and "
    "failed children become finding_unavailable rows, never lost audits)",
    labelnames=("outcome",),
)
FANOUT_FINDINGS = _reg.counter(
    "opsagent_fanout_findings_total",
    "Findings merged by the fan-out reduce phase, by severity "
    "(closed enum: critical/high/medium/low/none/unavailable)",
    labelnames=("severity",),
)
FANOUT_REPREFILL_AVOIDED = _reg.counter(
    "opsagent_fanout_reprefill_avoided_tokens_total",
    "Shared-prefix prompt tokens fan-out children served from cache "
    "instead of re-prefilling (the fleet-global-KV win the fan-out "
    "exists to harvest)",
)
FANOUT_REDUCE_SECONDS = _reg.histogram(
    "opsagent_fanout_reduce_seconds",
    "Wall time of one fan-out reduce phase (merge + stable sort + "
    "canonical report)",
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
             0.25, 0.5, 1.0, 2.5),
)
FANOUT_ACTIVE = _reg.gauge(
    "opsagent_fanout_active",
    "Fan-out audits currently in flight in this process",
)
FANOUT_CHILDREN_TOTAL = _reg.gauge(
    "opsagent_fanout_children_planned",
    "Children planned by the most recent fan-out (top's done/total row)",
)
FANOUT_CHILDREN_DONE = _reg.gauge(
    "opsagent_fanout_children_done",
    "Children finished (any outcome) of the most recent fan-out",
)
FANOUT_PREFIX_HIT_RATE = _reg.gauge(
    "opsagent_fanout_prefix_hit_rate",
    "Shared-prefix hit rate of the most recent fan-out (prefix-cache "
    "tokens hit over children x shared-prefix tokens, 0..1)",
)

TRACE_RETENTION = _reg.counter(
    "opsagent_trace_retention_total",
    "Tail-based trace retention decisions at request finish "
    "(kept_anomalous = SLO breach/error/failover, always kept; "
    "kept_sampled = healthy, won the sample draw; dropped = healthy, "
    "lost it)",
    labelnames=("decision",),
)
HISTORY_SAMPLES = _reg.counter(
    "opsagent_history_samples_total",
    "Sampling sweeps the telemetry history store has taken",
)
HISTORY_POINTS = _reg.gauge(
    "opsagent_history_points",
    "Points resident in the telemetry history ring, by downsample tier "
    "(1s / 10s / 60s)",
    labelnames=("tier",),
)
HISTORY_BYTES = _reg.gauge(
    "opsagent_history_bytes",
    "Estimated resident bytes of the telemetry history ring (bounded "
    "by OPSAGENT_HISTORY_BYTES)",
)

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def metrics_text() -> str:
    """The exposition document for a GET /metrics scrape."""
    return get_registry().render()


def metrics_snapshot() -> dict:
    """Compact dict of every sample (bench.py folds this into BENCH
    JSON)."""
    return get_registry().snapshot()


# Imported AFTER the instrument handles exist: both modules record into
# them. ``flight`` owns the event ring + compile watchdog (its sources call
# ``flight.on_compile`` directly: nothing to register), ``slo`` the
# declared-objective evaluation; the SLO gauges join the scrape as a
# collector. ``attribution`` (the roofline cost ledger + goodput counters)
# and ``timeline`` (per-request phase assembly over the flight ring + trace
# store) complete the goodput-ledger surface.
from . import flight  # noqa: E402,F401
from . import slo  # noqa: E402,F401
from . import attribution  # noqa: E402,F401
from . import timeline  # noqa: E402,F401
from . import history  # noqa: E402,F401

_reg.add_collector(lambda: slo.get_watchdog().collect())
