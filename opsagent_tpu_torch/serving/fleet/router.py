"""The fleet router: a thin front-end that speaks the engine-server API
and spreads sessions over N engine replicas (the port's counterpart of
``opsagent_tpu/serving/fleet/router.py``: the same placement, migration,
failure containment, journeys and HTTP routes, its HTTP front end on the
standard library's ``ThreadingHTTPServer``).

Placement policy, in order:

1. **Sticky pinning** — a session (keyed by its opening messages, or an
   explicit ``session_id``/``user`` field) stays on the replica that
   served its first turn, as long as that replica is alive, admitting,
   and under its queue spill bound.
2. **Prefix affinity** — otherwise the replica whose advertised prefix
   digest covers the longest page-aligned prefix of the prompt wins
   (its trie/host pool already holds the KV; the follow-up turn skips
   the re-prefill entirely).
3. **Least-loaded goodput** — no cached state anywhere: the replica with
   the lowest occupancy/goodput load score takes the session.

Bounded queue spill-over bounces a route off an over-deep preferred
replica; when the session's pages live on the replica it is bounced FROM,
the router ships them over the KV-page transfer path first
(serving/fleet/transfer.py) so the receiving engine restores instead of
re-prefilling. Graceful drain parks a replica's running sessions,
migrates them (pages + salvaged tokens) to the rest of the fleet with
zero request errors, and deregisters the replica.

Disaggregated prefill lanes: replicas registered ``role=prefill`` take
long cold admissions (prompt >= the prefill threshold with no useful
affinity anywhere), run exactly one token, and their prefill KV flows to
the chosen decode replica through the same transfer path.

Two replica flavors behind one handle interface: ``LocalReplica`` wraps
an in-process ServingStack (tests, the fleet bench stage, co-hosted
fleets), ``HttpReplica`` a remote engine server (``serve-engine
--join-fleet``).

Failure containment: every replica call feeds a per-replica circuit
breaker (healthy → suspect → ejected with half-open probes, see
registry.ReplicaHealth); connect-phase failures retry on another replica
with exponential backoff + jitter; a replica dying mid-SSE triggers
failover that re-submits the request elsewhere and resumes the client
stream from the last emitted character (greedy decode makes the resumed
text byte-identical); queued cold admissions can be TTFT-hedged on a
second replica; and when every replica's queue is past the shed
watermark, new work gets 429 + Retry-After instead of deepening the
collapse. Fault points for all of these live in serving/faults.py.

Threads: the HTTP front end runs each request on its own handler thread,
which calls the router directly. An in-process replica's page copies
(``LocalReplica.export_pages`` / ``import_pages``, ``migrate_chain``, a
peer's fault-in) run on the calling thread under the engine's lock, on the
engine's stream, so they order against the replica's scheduler thread.
"""

from __future__ import annotations

import copy
import hashlib
import json
import os
import queue as queue_mod
import random
import threading
import time
import urllib.error
import urllib.request
from collections import OrderedDict
from dataclasses import dataclass, replace as dc_replace
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any
from urllib.parse import parse_qs, urlsplit

from ... import obs
from ...utils.logger import get_logger
from .. import faults
from ..scheduler import RequestError
from .client import replica_mesh
from .registry import ReplicaInfo, ReplicaRegistry, prompt_chain_keys
from .transfer import migrate_chain, pack_entries, unpack_entries

log = get_logger("fleet.router")

DEFAULT_PREFILL_THRESHOLD = 256   # prompt tokens; env/CLI overridable
DEFAULT_MAX_RETRIES = 2           # connect-phase retries per request
DEFAULT_MAX_FAILOVERS = 2         # mid-stream re-submissions per request
RETRY_BACKOFF_BASE_S = 0.05
RETRY_BACKOFF_CAP_S = 2.0


class ReplicaStreamBroken(ConnectionError):
    """A replica's SSE stream died (disconnect, or an in-band error
    chunk from a dying engine) before the finish chunk arrived."""


class OverloadError(RequestError):
    """Router admission control shed this request (HTTP 429); carries
    the Retry-After hint the HTTP front-end surfaces as a header."""

    def __init__(self, message: str, retry_after_s: int = 1):
        super().__init__(message, 429)
        self.retry_after_s = retry_after_s


def _retryable(e: BaseException) -> bool:
    """Failures worth re-routing: transport errors and engine-side (5xx)
    verdicts. Client errors (4xx: bad request, overload shed) would fail
    identically on every replica."""
    if isinstance(e, RequestError):
        return e.status >= 500
    return isinstance(
        e, (urllib.error.URLError, ConnectionError, TimeoutError, OSError)
    )


def _fanout_of(body: Any) -> str | None:
    """The fan-out ID a request body carries, if any (agent/fanout
    orchestrator children) — threaded through journeys and flight events
    so one fan-out is traceable end to end across the fleet."""
    try:
        fid = body.get("fanout_id")
    except AttributeError:
        return None
    return str(fid) if fid else None


def _chunk_content(chunk: Any) -> str:
    """Content delta carried by an SSE chunk dict ('' for head/finish)."""
    if not isinstance(chunk, dict):
        return ""
    choices = chunk.get("choices") or []
    if not choices:
        return ""
    return (choices[0].get("delta") or {}).get("content") or ""


def _is_head_chunk(chunk: Any) -> bool:
    """The role-announcement chunk that opens every stream (emitted once
    per client stream even across failovers)."""
    if not isinstance(chunk, dict):
        return False
    choices = chunk.get("choices") or []
    if not choices:
        return False
    return "role" in (choices[0].get("delta") or {})


def _trim_chunk_content(chunk: dict[str, Any], skip: int) -> dict[str, Any]:
    """Drop the first ``skip`` chars of a chunk's content delta — the
    failover seam lands mid-chunk and the prefix was already delivered."""
    out = copy.deepcopy(chunk)
    delta = out["choices"][0]["delta"]
    delta["content"] = delta["content"][skip:]
    return out


# -- replica handles ----------------------------------------------------------
class LocalReplica:
    """In-process replica handle over a ServingStack (serving/api.py)."""

    def __init__(self, stack: Any, replica_id: str, role: str = "decode"):
        self.stack = stack
        self.replica_id = replica_id
        self.role = role

    # routing data plane
    def chat_completion(self, body: dict[str, Any]) -> dict[str, Any]:
        return self.stack.chat_completion(body)

    def chat_completion_stream(self, body: dict[str, Any]):
        return self.stack.chat_completion_stream(body)

    def tokenize(self, body: dict[str, Any]) -> list[int]:
        from ..chat_template import apply_chat_template

        tools = (
            None if body.get("tool_choice") == "none" else body.get("tools")
        )
        return apply_chat_template(
            self.stack.engine.tokenizer, body.get("messages", []),
            model_family=self.stack.model_name, tools=tools,
        )

    # registry feeds
    def info(self) -> ReplicaInfo:
        eng = self.stack.engine
        return ReplicaInfo(
            replica_id=self.replica_id,
            model=self.stack.model_name,
            role=self.role,
            capacity=int(eng.cfg.max_batch_size),
            page_size=int(eng.cfg.page_size),
            mesh=replica_mesh(eng),
            digests=set(self.prefix_digests()),
            load=self.load_snapshot(),
            local=True,
            handle=self,
        )

    def load_snapshot(self) -> dict[str, Any]:
        eng = self.stack.engine
        sched = self.stack.scheduler
        out = {
            "running": len(sched._running),
            "queued": len(sched._waiting) + sched._queue.qsize(),
            "prefilling": len(sched._prefilling),
            "free_pages": eng.alloc.free_pages,
            "goodput": {},
        }
        if eng.offload is not None:
            out["host_pool_pages"] = eng.offload.pool.num_pages
        return out

    def prefix_digests(self) -> list[str]:
        return self.stack.engine.prefix_digests()

    def digests_truncated(self) -> bool:
        return self.stack.engine.digests_truncated()

    # KV transfer plane
    def park_tokens(self, token_ids: list[int]) -> int:
        eng = self.stack.engine
        parked = eng.park_chain(token_ids)
        eng.offload_flush()
        return parked

    def export_pages(
        self, token_ids: list[int], park: bool = True,
        start_page: int = 0,
    ) -> list[dict[str, Any]]:
        eng = self.stack.engine
        if eng.offload is None:
            return []
        if park:
            self.park_tokens(token_ids)
        else:
            # Peer fault-in must not cost this replica its own cache:
            # replicate trie-resident pages into the pool (copy, not
            # evict) so the pack below can serve them.
            eng.replicate_chain(token_ids)
        return pack_entries(
            eng.offload.pool.match(token_ids, start_page=start_page)
        )

    def import_pages(self, records: list[dict[str, Any]]) -> int:
        eng = self.stack.engine
        if eng.offload is None:
            return 0
        n = 0
        for tokens, tree in unpack_entries(records, eng.cache):
            if eng.offload.pool.put(tokens, tree):
                n += 1
        return n

    # drain plane
    def drain_sessions(self) -> list[Any]:
        return self.stack.scheduler.drain_for_migration()

    def submit_request(self, req: Any) -> None:
        self.stack.scheduler.submit(req)

    # observability plane
    def slo(self) -> dict[str, Any]:
        return obs.slo.evaluate()

    def history(self, **kwargs: Any) -> dict[str, Any]:
        return obs.history.query(**kwargs)

    def timeline(self, request_id: str) -> dict[str, Any] | None:
        return obs.timeline.assemble(request_id)

    def flight(
        self, n: int = 256, kind: str = ""
    ) -> list[dict[str, Any]]:
        return obs.flight.get_recorder().snapshot(n=n, kind=kind or None)

    def close(self) -> None:
        self.stack.close()


class HttpReplica:
    """Remote replica handle over the engine server's HTTP surface."""

    def __init__(self, url: str, replica_id: str, timeout_s: float = 300.0):
        self.url = url.rstrip("/")
        self.replica_id = replica_id
        self.timeout_s = timeout_s

    @staticmethod
    def _hop_headers(body: Any) -> dict[str, str]:
        """X-Fleet-* hop annotation headers mirroring ``fleet_hop`` in
        the body (the wire spec: body field primary; the headers let a
        front proxy that strips unknown body fields still propagate the
        journey ID to the replica)."""
        hop = body.get("fleet_hop") if isinstance(body, dict) else None
        if not isinstance(hop, dict) or not hop.get("request_id"):
            return {}
        return {
            "X-Fleet-Request-Id": str(hop["request_id"]),
            "X-Fleet-Hop": str(hop.get("hop", "")),
            "X-Fleet-Replica": str(hop.get("replica", "")),
        }

    def _call(
        self, path: str, body: dict | None = None,
        timeout_s: float | None = None,
        headers: dict[str, str] | None = None,
    ) -> dict[str, Any]:
        faults.maybe_raise(
            "fleet.connect",
            urllib.error.URLError(ConnectionRefusedError(
                "injected connection refused"
            )),
            replica=self.replica_id, path=path,
        )
        faults.maybe_raise(
            "fleet.timeout", TimeoutError, "injected request timeout",
            replica=self.replica_id, path=path,
        )
        data = None if body is None else json.dumps(body).encode("utf-8")
        hdrs = {"Content-Type": "application/json"}
        if headers:
            hdrs.update(headers)
        req = urllib.request.Request(
            self.url + path, data=data, headers=hdrs,
        )
        with urllib.request.urlopen(  # noqa: S310 - operator-registered URL
            req, timeout=timeout_s or self.timeout_s
        ) as resp:
            return json.loads(resp.read().decode("utf-8"))

    def chat_completion(self, body: dict[str, Any]) -> dict[str, Any]:
        try:
            return self._call(
                "/v1/chat/completions", body,
                headers=self._hop_headers(body),
            )
        except urllib.error.HTTPError as e:  # surface the engine's verdict
            try:
                payload = json.loads(e.read().decode("utf-8"))
                msg = payload.get("error", {}).get("message", str(e))
            except Exception:  # noqa: BLE001
                msg = str(e)
            raise RequestError(msg, e.code) from e

    def chat_completion_stream(self, body: dict[str, Any]):
        """SSE pass-through: yields parsed chunk dicts like the local
        generator, so the router's stream handler treats both alike."""
        faults.maybe_raise(
            "fleet.connect",
            urllib.error.URLError(ConnectionRefusedError(
                "injected connection refused"
            )),
            replica=self.replica_id, path="/v1/chat/completions",
        )
        data = json.dumps(dict(body, stream=True)).encode("utf-8")
        req = urllib.request.Request(
            self.url + "/v1/chat/completions", data=data,
            headers={
                "Content-Type": "application/json",
                **self._hop_headers(body),
            },
        )
        with urllib.request.urlopen(  # noqa: S310
            req, timeout=self.timeout_s
        ) as resp:
            for raw in resp:
                line = raw.decode("utf-8").strip()
                if not line.startswith("data: "):
                    continue
                payload = line[len("data: "):]
                if payload == "[DONE]":
                    return
                yield json.loads(payload)

    def load_snapshot(self) -> dict[str, Any]:
        h = self._call("/healthz", timeout_s=5.0)
        return {
            "running": h.get("running", 0),
            "queued": h.get("queued", 0),
            "prefilling": h.get("prefilling", 0),
            "free_pages": h.get("free_pages", 0),
            "goodput": h.get("goodput", {}),
        }

    def prefix_digests(self) -> list[str]:
        return self._call("/fleet/digests", timeout_s=10.0).get(
            "digests", []
        )

    def park_tokens(self, token_ids: list[int]) -> int:
        return int(self._call(
            "/fleet/park", {"tokens": token_ids}, timeout_s=30.0
        ).get("parked_tokens", 0))

    def export_pages(
        self, token_ids: list[int], park: bool = True,
        start_page: int = 0,
    ) -> list[dict[str, Any]]:
        out = self._call(
            "/fleet/kv/export",
            {
                "chains": [
                    {"tokens": token_ids, "start_page": start_page}
                ],
                "park": park,
            },
            timeout_s=60.0,
        )
        results = out.get("results")
        if results:
            return results[0].get("pages", [])
        return out.get("pages", [])

    def import_pages(self, records: list[dict[str, Any]]) -> int:
        return int(self._call(
            "/fleet/kv/import", {"pages": records}, timeout_s=60.0
        ).get("imported", 0))

    def drain_sessions(self) -> list[Any]:
        # Cross-process live-request hand-off would need the router to own
        # the client connection end-to-end; today an HTTP drain stops
        # admissions (the replica finishes what it runs) and the parked
        # idle sessions migrate lazily on their next turn.
        try:
            self._call("/fleet/drain", {}, timeout_s=10.0)
        except Exception:  # noqa: BLE001 - best-effort notification
            log.exception("drain notification to %s failed", self.url)
        return []

    def slo(self) -> dict[str, Any]:
        return self._call("/api/slo", timeout_s=10.0)

    def history(
        self, series: list[str] | None = None, since: float = 300.0,
        step: float | None = None,
    ) -> dict[str, Any]:
        q = f"?since={since}"
        if series:
            q += "&series=" + ",".join(series)
        if step:
            q += f"&step={step}"
        return self._call(f"/api/metrics/history{q}", timeout_s=10.0)

    def timeline(self, request_id: str) -> dict[str, Any] | None:
        try:
            return self._call(
                f"/api/timeline/{request_id}", timeout_s=10.0
            )
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None
            raise

    def flight(
        self, n: int = 256, kind: str = ""
    ) -> list[dict[str, Any]]:
        q = f"?n={int(n)}"
        if kind:
            q += f"&kind={kind}"
        out = self._call(f"/api/debug/flight{q}", timeout_s=10.0)
        return out.get("events", [])


# -- routing decisions --------------------------------------------------------
def _merge_class_reports(
    reports: list[list[dict[str, Any]]], budget: float
) -> list[dict[str, Any]]:
    """Fold per-replica SLO-class reports into one fleet view: requests,
    bad, and outcome counts sum; attainment is recomputed from the sums;
    p95 latencies take the worst replica (a fleet p95 cannot be computed
    from per-replica quantiles — max is the honest bound); history
    windows merge per label with request-weighted attainment."""
    by_cls: dict[str, dict[str, Any]] = {}
    for rows in reports:
        for c in rows or []:
            cls = c.get("class")
            if not cls:
                continue
            m = by_cls.setdefault(cls, {
                "class": cls, "requests": 0, "bad": 0,
                "ttft_p95_ms": None, "itl_p95_ms": None,
                "outcomes": {}, "_windows": {},
            })
            m["requests"] += int(c.get("requests") or 0)
            m["bad"] += int(c.get("bad") or 0)
            for k in ("ttft_p95_ms", "itl_p95_ms"):
                v = c.get(k)
                if v is not None:
                    m[k] = v if m[k] is None else max(m[k], v)
            for o, n in (c.get("outcomes") or {}).items():
                m["outcomes"][o] = m["outcomes"].get(o, 0) + int(n)
            for label, w in (c.get("windows") or {}).items():
                mw = m["_windows"].setdefault(
                    label, {"requests": 0, "good": 0.0}
                )
                wr = int(w.get("requests") or 0)
                mw["requests"] += wr
                mw["good"] += wr * float(w.get("attainment") or 0.0)
    out: list[dict[str, Any]] = []
    for cls in obs.SLO_CLASSES:
        m = by_cls.get(cls)
        if m is None or m["requests"] <= 0:
            continue
        m["attainment"] = round(
            (m["requests"] - m["bad"]) / m["requests"], 6
        )
        windows: dict[str, Any] = {}
        for label, mw in m.pop("_windows").items():
            if mw["requests"] <= 0:
                continue
            att = mw["good"] / mw["requests"]
            windows[label] = {
                "requests": mw["requests"],
                "attainment": round(att, 6),
                "burn_rate": (
                    round((1.0 - att) / budget, 4) if budget > 0 else None
                ),
            }
        m["windows"] = windows
        out.append(m)
    return out


@dataclass
class RouteDecision:
    replica: ReplicaInfo
    policy: str                 # pinned|affinity|least_loaded|spill|forced
    affinity_pages: int = 0
    queue_depth: int = 0
    migrate_from: str | None = None   # replica id still holding the pages
    session: str = ""


class FleetRouter:
    """Placement + migration control plane. Thread-safe; the HTTP app
    drives it from its handler threads, tests call it directly."""

    def __init__(
        self,
        registry: ReplicaRegistry | None = None,
        affinity: bool = True,
        queue_spill: int | None = None,
        prefill_threshold: int = DEFAULT_PREFILL_THRESHOLD,
        tokenizer: Any = None,
        model_family: str = "",
        sticky: bool = True,
        placement: str = "affinity",
        max_retries: int = DEFAULT_MAX_RETRIES,
        max_failovers: int = DEFAULT_MAX_FAILOVERS,
        hedge_queue_depth: int | None = None,
        shed_queue_depth: int | None = None,
        batch_shed_queue_depth: int | None = None,
        pagestore: bool = True,
        journeys: bool | None = None,
    ):
        """``sticky=False`` disables session->replica pinning (every turn
        re-places from scratch). ``placement="round_robin"`` replaces the
        whole policy with a stateless rotation — the bench fleet-affinity
        stage's OFF phase, and what a cache-oblivious load balancer in
        front of the same replicas would do. (Least-loaded alone is NOT a
        fair no-affinity baseline for turn-based sessions: a session's
        own replica frees a slot the instant its turn ends, so occupancy
        routes the follow-up straight back home by accident.)

        Failure containment knobs: ``max_retries`` bounds connect-phase
        re-routes per request, ``max_failovers`` bounds mid-stream
        re-submissions, ``hedge_queue_depth`` (None = off) races a
        duplicate of a queued cold non-streaming admission on a second
        replica, ``shed_queue_depth`` (None = off) sheds new admissions
        with 429 + Retry-After once EVERY live decode replica's queue
        is at or past the watermark. ``batch_shed_queue_depth`` is the
        earlier watermark for batch/background requests (default: half
        of ``shed_queue_depth``, floor 1) — fan-out children soak
        LEFTOVER capacity, so batch work backs off before it can be
        what pushes interactive traffic to its own shed line.

        ``pagestore`` wires every ``add_local`` replica's engine with a
        fleet-global KV fault-in client against this router's directory
        (fleet/pagestore.py): an admission that misses its local trie +
        host pool fetches the chain peer-to-peer instead of
        re-prefilling. With the directory on, affinity placement is a
        locality optimization, not a correctness crutch — any live
        replica can serve a known session. ``pagestore=False`` is the
        A/B OFF phase (pre-directory behavior).

        ``journeys`` (default: ``$OPSAGENT_FLEET_JOURNEYS`` != "0")
        turns on fleet request journeys: the router mints one journey ID
        per request, stamps every replica hop with it (the engine adopts
        the ID), tracks participants per request, and serves stitched
        cross-replica timelines. ``journeys=False`` is the obs-overhead
        A/B OFF phase — requests route identically but carry no stamps
        and the participants map stays empty."""
        self.registry = registry or ReplicaRegistry()
        self.affinity = affinity
        self.sticky = sticky
        self.placement = placement
        self._rr = 0
        self.queue_spill = queue_spill
        self.prefill_threshold = prefill_threshold
        self.max_retries = max_retries
        self.max_failovers = max_failovers
        self.hedge_queue_depth = hedge_queue_depth
        self.shed_queue_depth = shed_queue_depth
        self.batch_shed_queue_depth = batch_shed_queue_depth
        self._tokenizer = tokenizer
        self._model_family = model_family
        self.pagestore = pagestore
        if journeys is None:
            journeys = os.environ.get(
                "OPSAGENT_FLEET_JOURNEYS", "1"
            ) != "0"
        self.journeys = journeys
        self._lock = threading.Lock()
        self._pins: OrderedDict[str, str] = OrderedDict()     # session->rid
        # Append-only participants map (bounded LRU), one record per
        # journey: every replica hop (route / stream / failover / hedge /
        # prefill / migrate) appends here, so a hedged or failed-over
        # request keeps its WHOLE replica set — not just the final
        # winner (the old ``_owners`` map's partial-story bug).
        self._participants: OrderedDict[str, dict[str, Any]] = \
            OrderedDict()
        self._max_map = 8192
        # Elastic scale-out (serving/fleet/autoscale.py): None = a static
        # fleet; an Autoscaler hears every shed (note_shed) and shows on
        # /healthz.
        self.autoscaler: Any = None
        # Anomaly dumps in this process gain the triggering request's
        # cross-replica journey (obs/flight.py _dump_context).
        obs.flight.set_journey_provider(self.journey_of)

    # -- membership convenience -------------------------------------------
    def add_local(
        self, stack: Any, replica_id: str, role: str = "decode"
    ) -> LocalReplica:
        """Register an in-process ServingStack as a replica.
        ``role="standby"`` keeps it out of the routable decode set until
        it is promoted (``registry.set_role``)."""
        handle = LocalReplica(stack, replica_id, role=role)
        self.registry.register(handle.info())
        if self.pagestore and stack.engine.offload is not None:
            from .pagestore import local_client

            stack.engine.pagestore = local_client(
                self.registry, replica_id, stack.engine
            )
        return handle

    # -- session identity ---------------------------------------------------
    @staticmethod
    def session_key(body: dict[str, Any]) -> str:
        """Stable identity of a conversation: an explicit session_id/user
        field wins; otherwise the digest of the opening (system + first
        user) messages — which every follow-up turn of an agent session
        re-sends verbatim at the head of its history."""
        explicit = body.get("session_id") or body.get("user")
        if explicit:
            return str(explicit)
        head = []
        for m in body.get("messages", []):
            head.append((m.get("role", ""), str(m.get("content", ""))))
            if m.get("role") == "user":
                break
        return hashlib.blake2b(
            json.dumps(head, ensure_ascii=False).encode("utf-8"),
            digest_size=12,
        ).hexdigest()

    def tokenize(self, body: dict[str, Any]) -> list[int] | None:
        """Prompt token ids for affinity scoring: the router-owned
        tokenizer when configured (HTTP fleets), else the first live
        local replica's engine tokenizer (in-process fleets). None
        disables affinity for this request (least-loaded still routes)."""
        if self._tokenizer is not None:
            from ..chat_template import apply_chat_template

            tools = (
                None if body.get("tool_choice") == "none"
                else body.get("tools")
            )
            return apply_chat_template(
                self._tokenizer, body.get("messages", []),
                model_family=self._model_family, tools=tools,
            )
        for info in self.registry.alive(admitting=False):
            if info.local and info.handle is not None:
                try:
                    return info.handle.tokenize(body)
                except Exception:  # noqa: BLE001 - affinity is best-effort
                    log.exception("local tokenize failed")
                    return None
        return None

    # -- placement ----------------------------------------------------------
    def _spill_bound(self, info: ReplicaInfo) -> int:
        return self.queue_spill if self.queue_spill is not None \
            else max(2, info.capacity)

    def route(
        self,
        body: dict[str, Any],
        token_ids: list[int] | None = None,
        force_replica: str | None = None,
        exclude: set[str] | None = None,
    ) -> RouteDecision:
        """``exclude`` drops replicas the caller just watched fail (the
        retry/failover loops); when exclusion would empty the fleet the
        full candidate set is kept — retrying the only replica beats
        failing outright. Routing onto an ejected-past-cooldown replica
        marks its half-open probe (the call outcome closes or re-opens
        the breaker)."""
        d = self._route_inner(body, token_ids, force_replica, exclude)
        health = self.registry.health_of(d.replica.replica_id)
        if health is not None and health.state == "ejected":
            self.registry.begin_probe(d.replica.replica_id)
            obs.flight.record(
                "replica_probe", replica=d.replica.replica_id,
                session=d.session,
            )
        return d

    def _route_inner(
        self,
        body: dict[str, Any],
        token_ids: list[int] | None = None,
        force_replica: str | None = None,
        exclude: set[str] | None = None,
    ) -> RouteDecision:
        self.registry.refresh_local()
        skey = self.session_key(body)
        candidates = self.registry.alive(role="decode")
        if exclude:
            kept = [
                c for c in candidates if c.replica_id not in exclude
            ]
            if kept:
                candidates = kept
        if not candidates:
            raise RequestError("no live decode replicas in the fleet", 503)
        if self.placement == "round_robin" and force_replica is None:
            with self._lock:
                pick = candidates[self._rr % len(candidates)]
                self._rr += 1
            return RouteDecision(
                pick, "round_robin",
                queue_depth=pick.queue_depth(), session=skey,
            )
        with self._lock:
            pinned_id = self._pins.get(skey) if self.sticky else None
        pinned = next(
            (c for c in candidates if c.replica_id == pinned_id), None
        )
        # Affinity scores (pages of cached prefix per replica).
        scores: dict[str, int] = {}
        if self.affinity and token_ids:
            by_psize: dict[int, list[str]] = {}
            for c in candidates:
                keys = by_psize.get(c.page_size)
                if keys is None:
                    keys = prompt_chain_keys(token_ids, c.page_size)
                    by_psize[c.page_size] = keys
                scores[c.replica_id] = c.affinity_pages(keys)

        def best_of(pool: list[ReplicaInfo]) -> tuple[ReplicaInfo, str, int]:
            """(replica, policy, affinity_pages) over ``pool``: longest
            cached prefix wins; ties and score-0 fall to least-loaded."""
            if scores:
                top = max(
                    pool, key=lambda c: (
                        scores.get(c.replica_id, 0) * c.page_size,
                        -c.load_score(),
                    ),
                )
                if scores.get(top.replica_id, 0) > 0:
                    return top, "affinity", scores[top.replica_id]
            top = min(pool, key=lambda c: c.load_score())
            return top, "least_loaded", scores.get(top.replica_id, 0)

        def holder_of_pages(exclude: str) -> str | None:
            """The replica (any state, any role) best holding this
            prompt's pages, for migrate-from bookkeeping."""
            best_id, best_score = None, 0
            for info in self.registry.all():
                if info.replica_id == exclude:
                    continue
                s = scores.get(info.replica_id, 0)
                if s > best_score:
                    best_id, best_score = info.replica_id, s
            if best_id is None and pinned_id and pinned_id != exclude:
                best_id = pinned_id
            return best_id

        if force_replica is not None:
            forced = self.registry.get(force_replica)
            if forced is None:
                raise RequestError(
                    f"unknown replica {force_replica!r}", 404
                )
            return RouteDecision(
                forced, "forced",
                affinity_pages=scores.get(force_replica, 0),
                queue_depth=forced.queue_depth(),
                migrate_from=holder_of_pages(force_replica),
                session=skey,
            )
        if pinned is not None:
            depth = pinned.queue_depth()
            if depth < self._spill_bound(pinned):
                return RouteDecision(
                    pinned, "pinned",
                    affinity_pages=scores.get(pinned.replica_id, 0),
                    queue_depth=depth, session=skey,
                )
            # Bounded spill-over: the preferred replica's queue is too
            # deep; route elsewhere and bring the pages along.
            obs.FLEET_SPILLOVERS.inc()
            others = [c for c in candidates if c is not pinned]
            if others:
                top, _, pages = best_of(others)
                mig = (
                    pinned.replica_id
                    if scores.get(pinned.replica_id, 0) > pages else None
                )
                return RouteDecision(
                    top, "spill", affinity_pages=pages,
                    queue_depth=top.queue_depth(),
                    migrate_from=mig, session=skey,
                )
            return RouteDecision(
                pinned, "pinned",
                affinity_pages=scores.get(pinned.replica_id, 0),
                queue_depth=depth, session=skey,
            )
        top, policy, pages = best_of(candidates)
        mig = None
        if policy == "least_loaded":
            mig = holder_of_pages(top.replica_id)
        return RouteDecision(
            top, policy, affinity_pages=pages,
            queue_depth=top.queue_depth(), migrate_from=mig, session=skey,
        )

    def _record_decision(
        self, d: RouteDecision, request_id: str | None = None,
        fanout_id: str | None = None,
    ) -> None:
        obs.FLEET_ROUTE_DECISIONS.inc(policy=d.policy)
        obs.FLEET_AFFINITY_PAGES.observe(float(d.affinity_pages))
        obs.flight.record(
            "route_decision", replica=d.replica.replica_id,
            policy=d.policy, affinity_pages=d.affinity_pages,
            affinity_tokens=d.affinity_pages * d.replica.page_size,
            queue_depth=d.queue_depth, session=d.session,
            **({"request_id": request_id} if request_id else {}),
            **({"fanout_id": fanout_id} if fanout_id else {}),
        )

    # -- journey bookkeeping -------------------------------------------------
    # Journey shapes in escalation order: a journey counts once, under
    # its most eventful shape (a hedged request that then fails over is
    # a failover journey).
    _SHAPE_RANK = {"direct": 0, "retried": 1, "hedged": 2, "failover": 3}

    def _new_journey(self, body: Any = None) -> str | None:
        """Mint the journey ID the engine will ADOPT as its completion
        id (same chatcmpl- namespace) and open its participants record.
        None when journeys are off (the obs-overhead kill switch)."""
        if not self.journeys:
            return None
        jid = obs.new_request_id("chatcmpl")
        fanout_id = _fanout_of(body)
        with self._lock:
            self._participants[jid] = {
                "t0_wall": time.time(), "shape": "direct",
                "class": obs.slo.classify(body),
                "replicas": [], "hops": [],
                **({"fanout_id": fanout_id} if fanout_id else {}),
            }
            while len(self._participants) > self._max_map:
                self._participants.popitem(last=False)
        return jid

    def _journey_class(self, jid: str | None) -> str:
        with self._lock:
            rec = self._participants.get(jid) if jid else None
        return (rec or {}).get("class") or "interactive"

    def _stamp_hop(
        self, body: dict[str, Any], jid: str | None, hop: str,
        replica_id: str,
    ) -> dict[str, Any]:
        """Copy of ``body`` stamped with the fleet hop annotation the
        engine pops and adopts; the caller's body stays clean so a
        retry/failover leg restamps with its own hop kind."""
        if not jid:
            return body
        out = dict(body)
        out["fleet_hop"] = {
            "request_id": jid, "hop": hop, "replica": replica_id,
        }
        return out

    def _note_hop(
        self, jid: str | None, replica_id: str, hop: str, **extra: Any
    ) -> None:
        """Append one hop record to the journey BEFORE dispatching, so
        the participants map holds every replica the request touched
        even when the touch fails (the failed leg is exactly the one
        the postmortem needs)."""
        if not jid:
            return
        with self._lock:
            rec = self._participants.get(jid)
            if rec is None:
                return
            if replica_id and replica_id not in rec["replicas"]:
                rec["replicas"].append(replica_id)
            rec["hops"].append({
                "hop": hop, "replica": replica_id,
                "wall": time.time(), **extra,
            })
            self._participants.move_to_end(jid)

    def _note_shape(self, jid: str | None, shape: str) -> None:
        if not jid:
            return
        with self._lock:
            rec = self._participants.get(jid)
            if rec is not None and (
                self._SHAPE_RANK.get(shape, 0)
                > self._SHAPE_RANK.get(rec.get("shape", "direct"), 0)
            ):
                rec["shape"] = shape

    def _finish_journey(self, jid: str | None) -> None:
        """Count the completed journey once, under its final shape and
        SLO class."""
        if not jid:
            return
        with self._lock:
            rec = self._participants.get(jid)
            if rec is None or rec.get("counted"):
                return
            rec["counted"] = True
            shape = rec.get("shape", "direct")
            cls = rec.get("class") or "interactive"
        obs.FLEET_JOURNEYS.inc(**{"shape": shape, "class": cls})

    def journey_of(self, request_id: str) -> dict[str, Any] | None:
        """The cross-replica journey of a tracked request (shape +
        replicas + hops) — the flight recorder's journey provider, so
        anomaly dumps naming a request carry its whole fleet story."""
        with self._lock:
            rec = self._participants.get(request_id)
            if rec is None:
                return None
            return {
                "shape": rec.get("shape", "direct"),
                "replicas": list(rec["replicas"]),
                "hops": [dict(h) for h in rec["hops"]],
            }

    def participants_of(self, request_id: str) -> dict[str, Any] | None:
        with self._lock:
            rec = self._participants.get(request_id)
            if rec is None:
                return None
            return {
                "t0_wall": rec.get("t0_wall"),
                "shape": rec.get("shape", "direct"),
                "replicas": list(rec["replicas"]),
                "hops": [dict(h) for h in rec["hops"]],
            }

    def _note_ownership(
        self, d: RouteDecision, resp_id: str | None,
        jid: str | None = None,
    ) -> None:
        with self._lock:
            if self.sticky:
                self._pins[d.session] = d.replica.replica_id
                self._pins.move_to_end(d.session)
                while len(self._pins) > self._max_map:
                    self._pins.popitem(last=False)
            if resp_id and jid and resp_id != jid:
                # The replica did NOT adopt the journey id (journeys
                # disabled replica-side, or an older build): alias the
                # record under the id the client actually holds.
                rec = self._participants.get(jid)
                if rec is not None:
                    self._participants[resp_id] = rec
                    while len(self._participants) > self._max_map:
                        self._participants.popitem(last=False)
            elif resp_id and not jid:
                # Journeys off router-side: keep a minimal final-replica
                # record so timeline lookups still resolve.
                self._participants[resp_id] = {
                    "t0_wall": time.time(), "shape": "direct",
                    "replicas": [d.replica.replica_id], "hops": [],
                }
                while len(self._participants) > self._max_map:
                    self._participants.popitem(last=False)

    def _maybe_migrate(
        self, d: RouteDecision, token_ids: list[int] | None, reason: str,
        jid: str | None = None,
    ) -> None:
        if d.migrate_from is None or not token_ids:
            return
        if reason == "misroute" and self.pagestore:
            # Fleet-global KV demotes the eager misroute push: the
            # receiving replica faults the chain in (pull) through the
            # page directory at admission, so a push here would only
            # duplicate the transfer. Failover and drain pushes stay —
            # their source is failing/leaving and may be gone from the
            # directory by the time the receiver asks.
            return
        src = self.registry.get(d.migrate_from)
        if src is None or src.handle is None or d.replica.handle is None:
            return
        self._note_hop(jid, d.migrate_from, "migrate", reason=reason)
        migrate_chain(
            src.handle, d.replica.handle, token_ids,
            reason=reason, session=d.session, request_id=jid or "",
        )

    def _maybe_prefill_lane(
        self, d: RouteDecision, body: dict[str, Any],
        token_ids: list[int] | None, jid: str | None = None,
    ) -> None:
        """Disaggregated prefill: a long cold admission runs its prefill
        on a role=prefill replica, whose KV then flows to the chosen
        decode replica over the transfer path; the decode replica's
        admission restores the prompt pages instead of prefilling them."""
        if not token_ids or len(token_ids) < self.prefill_threshold:
            return
        covered = d.affinity_pages * d.replica.page_size
        if covered * 2 >= len(token_ids):
            return  # warm enough locally; the lane would only add copies
        lanes = self.registry.alive(role="prefill")
        if not lanes or d.replica.handle is None:
            return
        lane = min(lanes, key=lambda c: c.load_score())
        if lane.handle is None:
            return
        obs.FLEET_ROUTE_DECISIONS.inc(policy="prefill")
        obs.flight.record(
            "route_decision", replica=lane.replica_id, policy="prefill",
            affinity_pages=0, queue_depth=lane.queue_depth(),
            session=d.session,
            **({"request_id": jid} if jid else {}),
        )
        self._note_hop(jid, lane.replica_id, "prefill")
        t0 = time.perf_counter()
        try:
            pre_body = dict(body)
            pre_body.pop("stream", None)
            pre_body.pop("n", None)
            pre_body["max_tokens"] = 1
            lane.handle.chat_completion(
                self._stamp_hop(pre_body, jid, "prefill", lane.replica_id)
            )
        except Exception:  # noqa: BLE001 - the lane is an optimization
            log.exception("prefill lane failed; decode replica prefills")
            return
        finally:
            if jid:
                obs.FLEET_HOP_SECONDS.observe(
                    time.perf_counter() - t0, hop="prefill"
                )
        migrate_chain(
            lane.handle, d.replica.handle, token_ids,
            reason="prefill_handoff", session=d.session,
            request_id=jid or "",
        )

    # -- overload shedding ---------------------------------------------------
    def _check_overload(
        self, force_replica: str | None, body: Any = None
    ) -> None:
        """Router admission control: once EVERY live decode replica's
        queue depth is at or past the watermark, new work is shed with
        429 + Retry-After BEFORE it deepens the queues (backpressure to
        the client instead of melted replicas). Forced routes (operator
        overrides, drain tooling) bypass the shed. The shed is classed
        (``opsagent_fleet_shed_total{class}``).

        The watermark is per class: batch/background admissions shed at
        ``batch_shed_queue_depth`` (default half the interactive
        watermark), so a fan-out wave only soaks capacity interactive
        traffic is not using — batch demand backs off while interactive
        requests still admit freely."""
        if self.shed_queue_depth is None or force_replica is not None:
            return
        cls = obs.slo.classify(body)
        watermark = self.shed_queue_depth
        if cls != "interactive":
            watermark = (
                self.batch_shed_queue_depth
                if self.batch_shed_queue_depth is not None
                else max(1, self.shed_queue_depth // 2)
            )
        self.registry.refresh_local()
        cands = self.registry.alive(role="decode")
        if not cands:
            return  # route() raises its own 503
        depths = [c.queue_depth() for c in cands]
        if min(depths) < watermark:
            return
        retry_after = int(min(30, max(1, min(depths))))
        obs.FLEET_SHED.inc(**{"class": cls})
        if self.autoscaler is not None:
            # Shed = demand the fleet turned away, the scale-up signal:
            # noted before the 429 leaves.
            self.autoscaler.note_shed(cls)
        obs.FLEET_REQUESTS.inc(outcome="shed")
        obs.CLASS_REQUESTS.inc(**{"class": cls, "outcome": "shed"})
        fanout_id = _fanout_of(body)
        obs.flight.record(
            "request_shed", min_queue_depth=min(depths),
            watermark=watermark, retry_after_s=retry_after,
            slo_class=cls,
            **({"fanout_id": fanout_id} if fanout_id else {}),
        )
        raise OverloadError(
            f"fleet overloaded: every replica queue depth >= {watermark} "
            f"(class {cls}); retry later", retry_after,
        )

    @staticmethod
    def _backoff(attempt: int) -> None:
        """Exponential backoff + jitter between re-routes. The jitter is
        real randomness on purpose — it decorrelates retrying clients;
        fault DECISIONS (faults.py) stay count-based so injected chaos
        is deterministic even though retry timing is not."""
        delay = min(
            RETRY_BACKOFF_CAP_S,
            RETRY_BACKOFF_BASE_S * (2 ** max(0, attempt - 1)),
        )
        time.sleep(delay * random.uniform(0.5, 1.0))

    # -- TTFT hedging --------------------------------------------------------
    def _pick_hedge_backup(self, d: RouteDecision) -> ReplicaInfo | None:
        """A queued COLD admission (no cached prefix anywhere to lose)
        whose chosen replica has ``hedge_queue_depth`` or more requests
        ahead of it is worth racing on a second replica: greedy decode
        is deterministic, so the duplicate is pure latency insurance."""
        if self.hedge_queue_depth is None or d.affinity_pages > 0:
            return None
        if d.queue_depth < self.hedge_queue_depth:
            return None
        others = [
            c for c in self.registry.alive(role="decode")
            if c.replica_id != d.replica.replica_id
            and c.handle is not None
        ]
        if not others:
            return None
        return min(others, key=lambda c: c.load_score())

    def _hedged_complete(
        self, body: dict[str, Any], d: RouteDecision, backup: ReplicaInfo,
        jid: str | None = None,
    ) -> tuple[RouteDecision, dict[str, Any]]:
        """Race the admission on primary + backup; first completion wins
        (the loser's work is discarded — greedy outputs are identical).
        Each arrival feeds the circuit breaker; the winner's decision is
        what gets recorded/pinned."""
        obs.FLEET_HEDGES.inc(**{"class": self._journey_class(jid)})
        self._note_shape(jid, "hedged")
        obs.flight.record(
            "fleet_hedge", primary=d.replica.replica_id,
            backup=backup.replica_id, queue_depth=d.queue_depth,
            session=d.session,
            **({"request_id": jid} if jid else {}),
        )
        results: queue_mod.Queue = queue_mod.Queue()

        def _run(info: ReplicaInfo, hop: str) -> None:
            self._note_hop(jid, info.replica_id, hop)
            t0 = time.perf_counter()
            try:
                resp = info.handle.chat_completion(
                    self._stamp_hop(body, jid, hop, info.replica_id)
                )
                results.put((info, resp, None))
            except Exception as e:  # noqa: BLE001 - raced; judged below
                results.put((info, None, e))
            finally:
                if jid:
                    obs.FLEET_HOP_SECONDS.observe(
                        time.perf_counter() - t0, hop=hop
                    )

        for info, hop in ((d.replica, "route"), (backup, "hedge")):
            threading.Thread(
                target=_run, args=(info, hop), daemon=True
            ).start()
        last_err: Exception | None = None
        for _ in range(2):
            info, resp, err = results.get()
            self.registry.note_result(info.replica_id, ok=err is None)
            if err is None:
                if info.replica_id == backup.replica_id:
                    return dc_replace(
                        d, replica=backup, policy="hedge",
                        queue_depth=backup.queue_depth(),
                    ), resp
                return d, resp
            last_err = err
        raise last_err  # both lost the race

    # -- request plane -------------------------------------------------------
    def complete(
        self, body: dict[str, Any], force_replica: str | None = None
    ) -> dict[str, Any]:
        token_ids = self.tokenize(body)
        self._check_overload(force_replica, body)
        jid = self._new_journey(body)
        excluded: set[str] = set()
        attempt = 0
        while True:
            d = self.route(
                body, token_ids, force_replica=force_replica,
                exclude=excluded,
            )
            if d.replica.handle is None:
                raise RequestError(
                    f"replica {d.replica.replica_id} has no handle", 503
                )
            self._maybe_migrate(
                d, token_ids,
                reason="failover" if excluded else "misroute", jid=jid,
            )
            if not excluded:
                self._maybe_prefill_lane(d, body, token_ids, jid=jid)
            backup = self._pick_hedge_backup(d) if not excluded else None
            rid_name = d.replica.replica_id
            try:
                if backup is not None:
                    d, resp = self._hedged_complete(body, d, backup, jid=jid)
                else:
                    self._note_hop(jid, rid_name, "route", attempt=attempt)
                    t_leg = time.perf_counter()
                    try:
                        resp = d.replica.handle.chat_completion(
                            self._stamp_hop(body, jid, "route", rid_name)
                        )
                    finally:
                        if jid:
                            obs.FLEET_HOP_SECONDS.observe(
                                time.perf_counter() - t_leg, hop="route"
                            )
                    self.registry.note_result(rid_name, ok=True)
            except Exception as e:  # noqa: BLE001 - classified below
                if backup is None:
                    self.registry.note_result(rid_name, ok=False)
                if (
                    attempt < self.max_retries and _retryable(e)
                    and force_replica is None
                ):
                    attempt += 1
                    excluded.add(rid_name)
                    self._note_shape(jid, "retried")
                    obs.FLEET_RETRIES.inc()
                    obs.flight.record(
                        "fleet_retry", replica=rid_name, attempt=attempt,
                        error=str(e)[:200],
                        **({"request_id": jid} if jid else {}),
                    )
                    self._backoff(attempt)
                    continue
                obs.FLEET_REQUESTS.inc(outcome="error")
                obs.trace.mark_anomalous(jid, reason="fleet_error")
                raise
            rid = resp.get("id") if isinstance(resp, dict) else None
            self._record_decision(
                d, request_id=rid or jid, fanout_id=_fanout_of(body),
            )
            self._note_ownership(d, rid, jid)
            self._finish_journey(jid)
            obs.FLEET_REQUESTS.inc(outcome="completed")
            if isinstance(resp, dict):
                resp.setdefault("fleet", {})["replica"] = \
                    d.replica.replica_id
                resp["fleet"]["policy"] = d.policy
            return resp

    def complete_stream(
        self, body: dict[str, Any], force_replica: str | None = None
    ):
        """Generator of SSE chunk dicts routed to the chosen replica.

        Mid-stream failover: when the serving replica dies (transport
        error, injected disconnect, or an in-band error chunk from a
        dying engine), the request is re-submitted to a surviving
        replica and the client stream RESUMES from the last emitted
        character offset — greedy re-prefill regenerates the identical
        text, the already-delivered prefix is skipped, so the client
        sees no gap, no duplicate, and no error. Non-greedy streams only
        fail over before the first content chunk (a resampled
        continuation would splice two different generations)."""
        token_ids = self.tokenize(body)
        self._check_overload(force_replica, body)
        jid = self._new_journey(body)
        try:
            greedy = float(body.get("temperature") or 0.0) == 0.0
        except (TypeError, ValueError):
            greedy = False
        excluded: set[str] = set()
        failovers = 0
        emitted_chars = 0     # content chars delivered to the client
        sent_head = False     # role chunk already delivered
        while True:
            d = self.route(
                body, token_ids, force_replica=force_replica,
                exclude=excluded,
            )
            if d.replica.handle is None:
                raise RequestError(
                    f"replica {d.replica.replica_id} has no handle", 503
                )
            self._maybe_migrate(
                d, token_ids,
                reason="failover" if failovers else "misroute", jid=jid,
            )
            if failovers == 0:
                self._maybe_prefill_lane(d, body, token_ids, jid=jid)
            rid_name = d.replica.replica_id
            skip_chars = emitted_chars   # dedup on re-submit
            first = True
            hop_kind = "failover" if failovers else "stream"
            self._note_hop(jid, rid_name, hop_kind, failovers=failovers)
            t_leg = time.perf_counter()
            try:
                gen = d.replica.handle.chat_completion_stream(
                    self._stamp_hop(body, jid, hop_kind, rid_name)
                )
                for chunk in gen:
                    faults.maybe_raise(
                        "fleet.stream_disconnect",
                        ReplicaStreamBroken(
                            "injected mid-SSE disconnect"
                        ),
                        replica=rid_name,
                    )
                    if isinstance(chunk, dict) and "error" in chunk:
                        # In-band error chunk (the engine's scheduler
                        # failed the request mid-decode): to the client
                        # this replica is dead — fail over.
                        raise ReplicaStreamBroken(str(
                            chunk["error"].get("message", "stream error")
                        ))
                    if first:
                        req_id = chunk.get("id") \
                            if isinstance(chunk, dict) else None
                        self._record_decision(
                            d, request_id=req_id or jid,
                            fanout_id=_fanout_of(body),
                        )
                        self._note_ownership(d, req_id, jid)
                        first = False
                    content = _chunk_content(chunk)
                    if content:
                        if skip_chars >= len(content):
                            skip_chars -= len(content)
                            continue
                        if skip_chars > 0:
                            chunk = _trim_chunk_content(chunk, skip_chars)
                            content = content[skip_chars:]
                            skip_chars = 0
                        emitted_chars += len(content)
                        yield chunk
                        continue
                    if _is_head_chunk(chunk):
                        if sent_head:
                            continue
                        sent_head = True
                    yield chunk
                if jid:
                    obs.FLEET_HOP_SECONDS.observe(
                        time.perf_counter() - t_leg, hop=hop_kind
                    )
                self.registry.note_result(rid_name, ok=True)
                self._finish_journey(jid)
                obs.FLEET_REQUESTS.inc(outcome="completed")
                return
            except Exception as e:  # noqa: BLE001 - classified below
                if jid:
                    obs.FLEET_HOP_SECONDS.observe(
                        time.perf_counter() - t_leg, hop=hop_kind
                    )
                self.registry.note_result(rid_name, ok=False)
                resumable = greedy or emitted_chars == 0
                if (
                    failovers < self.max_failovers and _retryable(e)
                    and resumable and force_replica is None
                ):
                    failovers += 1
                    excluded.add(rid_name)
                    self._note_shape(jid, "failover")
                    obs.FLEET_FAILOVERS.inc()
                    # Tail-based retention: a failed-over journey is
                    # always investigation-worthy — pin its trace before
                    # the resumed leg even starts (the mark outlives the
                    # first leg's trace object).
                    obs.trace.mark_anomalous(jid, reason="failover")
                    obs.flight.record(
                        "failover", replica=rid_name,
                        failovers=failovers,
                        emitted_chars=emitted_chars,
                        error=str(e)[:200], session=d.session,
                        **({"request_id": jid} if jid else {}),
                    )
                    self._backoff(failovers)
                    continue
                obs.FLEET_REQUESTS.inc(outcome="error")
                obs.trace.mark_anomalous(jid, reason="fleet_error")
                raise

    # -- drain ----------------------------------------------------------------
    def drain(self, replica_id: str) -> dict[str, Any]:
        """Graceful drain: stop admitting to ``replica_id``, park its
        running sessions, migrate them (KV pages + salvaged requests) to
        the rest of the fleet, then deregister it. In-process replicas
        hand their live Request objects across schedulers, so clients
        (including streams) never see an error; HTTP replicas stop
        admitting and migrate lazily (see HttpReplica.drain_sessions)."""
        info = self.registry.get(replica_id)
        if info is None:
            raise RequestError(f"unknown replica {replica_id!r}", 404)
        self.registry.set_draining(replica_id, True)
        obs.flight.record("replica_drain", replica=replica_id, phase="enter")
        moved = 0
        errors = 0
        reqs: list[Any] = []
        if info.handle is not None:
            try:
                reqs = info.handle.drain_sessions()
            except Exception:  # noqa: BLE001
                log.exception("drain_sessions failed on %s", replica_id)
                errors += 1
        targets = [
            c for c in self.registry.alive(role="decode")
            if c.replica_id != replica_id and c.handle is not None
        ]
        for req in reqs:
            if not targets:
                # Nowhere to go: the request stays queued on the drained
                # replica's scheduler? No — the scheduler is stopped.
                # Fail it loudly rather than hanging the client forever.
                req.error = "fleet drain found no target replica"
                req.done.set()
                errors += 1
                continue
            dst = min(targets, key=lambda c: c.load_score())
            migrate_chain(
                info.handle, dst.handle, list(req.prompt_ids),
                reason="drain", park=False,
            )
            dst.handle.submit_request(req)
            moved += 1
        with self._lock:
            stale = [k for k, v in self._pins.items() if v == replica_id]
            for k in stale:
                del self._pins[k]
        self.registry.deregister(replica_id)
        obs.flight.record(
            "replica_drain", replica=replica_id, phase="exit",
            migrated=moved, errors=errors,
        )
        return {
            "replica": replica_id, "migrated_sessions": moved,
            "errors": errors,
        }

    # -- observability plane ---------------------------------------------------
    def owner_of(self, request_id: str) -> str | None:
        """Final serving replica of a tracked request — the last
        request-plane hop's replica. The full replica set lives in
        participants_of; this keeps the old owner-map contract for
        bench/operator callers."""
        with self._lock:
            rec = self._participants.get(request_id)
            if rec is None:
                return None
            for h in reversed(rec["hops"]):
                if h.get("hop") in ("route", "stream", "failover", "hedge"):
                    return h.get("replica") or None
            return rec["replicas"][-1] if rec["replicas"] else None

    def _timeline_single(self, request_id: str) -> dict[str, Any] | None:
        """Single-replica pass-through: forward to the owning replica so
        ``timeline`` / GET /api/timeline work through the
        router instead of 404ing. Unknown owners fall back to asking
        every live replica (the id may predate a router restart)."""
        rid = self.owner_of(request_id)
        candidates = []
        if rid is not None:
            info = self.registry.get(rid)
            if info is not None:
                candidates.append(info)
        if not candidates:
            candidates = self.registry.alive(admitting=False)
        for info in candidates:
            if info.handle is None:
                continue
            try:
                tl = info.handle.timeline(request_id)
            except Exception:  # noqa: BLE001 - try the next replica
                continue
            if tl is not None:
                tl["replica"] = info.replica_id
                return tl
        return None

    def timeline(self, request_id: str) -> dict[str, Any] | None:
        """Fleet-scope timeline: ask EVERY replica the participants map
        recorded for the journey, stitch their per-replica timelines
        (skew-corrected by the heartbeat clock-offset estimates) with
        the router-side routing/failover/hedge/fault-in windows into one
        multi-lane view. Requests without a journey record (journeys
        off, or pre-restart ids) degrade to the single-replica
        pass-through; reaped participants degrade to the survivors."""
        rec = self.participants_of(request_id)
        if rec is None:
            return self._timeline_single(request_id)
        sources: dict[str, dict[str, Any]] = {}
        reaped: list[str] = []
        shared_done = False
        for rid in rec["replicas"] or [None]:
            if rid is None:
                break
            info = self.registry.get(rid)
            if info is None or info.handle is None:
                reaped.append(rid)
                continue
            if isinstance(info.handle, LocalReplica):
                # In-process replicas share one trace store: assemble
                # the journey trace once under the shared lane and let
                # the stitcher attribute segments to replica lanes via
                # the trace's fleet legs.
                if not shared_done:
                    tl = obs.timeline.assemble(request_id)
                    if tl is not None:
                        sources["_shared"] = tl
                    shared_done = True
                continue
            try:
                tl = info.handle.timeline(request_id)
            except Exception:  # noqa: BLE001 - participant unreachable
                reaped.append(rid)
                continue
            if tl is not None:
                sources[rid] = tl
        if not sources:
            return self._timeline_single(request_id)
        try:
            events = self.fleet_flight(
                n=0, request_id=request_id
            ).get("events", [])
        except Exception:  # noqa: BLE001 - events only enrich windows
            events = []
        out = obs.timeline.stitch_fleet(
            request_id, sources, journey=rec,
            offsets=self.registry.clock_offsets(),
            reaped=reaped, events=events,
        )
        # Single-replica callers keep reading tl["replica"]: the final
        # serving replica (the full set is in tl["replicas"]).
        out["replica"] = self.owner_of(request_id) or ""
        return out

    def fleet_flight(
        self, n: int = 256, kind: str = "", request_id: str = "",
    ) -> dict[str, Any]:
        """GET /api/fleet/flight: every replica's flight ring merged
        into one replica-tagged, skew-corrected, time-ordered ledger.
        The router's own process ring is included once (it also covers
        all in-process replicas — they share it); remote replicas are
        polled over HTTP. ``request_id`` filters to one journey's
        events; ``n`` caps the merged tail (0 = no cap)."""
        offsets = self.registry.clock_offsets()
        merged: list[dict[str, Any]] = []
        replicas: list[str] = []

        def _ingest(evs: list[dict[str, Any]], src: str, off: float):
            for e in evs:
                if not isinstance(e, dict):
                    continue
                if request_id and e.get("request_id") != request_id:
                    continue
                e = dict(e)
                e.setdefault("replica", src)
                e["source"] = src
                if "wall" in e:
                    e["wall_corrected"] = e["wall"] - off
                merged.append(e)

        _ingest(
            obs.flight.get_recorder().snapshot(kind=kind or None),
            "router", 0.0,
        )
        for info in self.registry.alive(admitting=False):
            replicas.append(info.replica_id)
            if info.handle is None or isinstance(info.handle, LocalReplica):
                continue   # local replicas share the router's ring
            try:
                evs = info.handle.flight(
                    n=2048 if request_id else n, kind=kind
                )
            except Exception:  # noqa: BLE001 - degrade to survivors
                continue
            _ingest(evs, info.replica_id, offsets.get(info.replica_id, 0.0))
        merged.sort(
            key=lambda e: e.get("wall_corrected", e.get("wall", 0.0))
        )
        if n and not request_id:
            merged = merged[-n:]
        return {
            "replicas": replicas,
            "clock_offset_s": offsets,
            "events": merged,
        }

    def slo_aggregate(self) -> dict[str, Any]:
        """Fleet-wide /api/slo: every replica's verdicts concatenated
        (names prefixed with the replica id) in the standard shape, so
        ``slo-check --url <router>`` gates the whole fleet —
        one breached replica breaches the fleet."""
        slos: list[dict[str, Any]] = []
        replicas = 0
        # Per-class accounting starts from THIS process's report (sheds
        # are classified here; in-process replicas share this registry,
        # so their completions are already in it) and folds in each
        # REMOTE replica's classes — remote completions are classified
        # in the replica process, never here. LocalReplica handles are
        # skipped in the fold: their slo() reads the same process-wide
        # registry and would double-count.
        remote_classes: list[list[dict[str, Any]]] = []
        for info in self.registry.alive(admitting=False):
            if info.handle is None:
                continue
            try:
                verdicts = info.handle.slo()
            except Exception:  # noqa: BLE001 - unreachable replica
                slos.append({
                    "name": f"{info.replica_id}:reachable",
                    "pass": False, "unit": "",
                })
                continue
            replicas += 1
            for v in verdicts.get("slos", []):
                v = dict(v)
                v["name"] = f"{info.replica_id}:{v.get('name', '?')}"
                slos.append(v)
            if not isinstance(info.handle, LocalReplica):
                remote_classes.append(verdicts.get("classes") or [])
        budget = obs.slo._env_float(obs.slo._ENV_ERR, 0.01)
        classes = _merge_class_reports(
            [obs.slo.get_watchdog().class_report()] + remote_classes,
            budget,
        )
        return {
            "slos": slos,
            "classes": classes,
            "error_budget": budget,
            "fleet": {"replicas": replicas},
        }

    def metrics_history(
        self, series: list[str] | None = None, since: float = 300.0,
        step: float | None = None,
    ) -> dict[str, Any]:
        """Fleet-wide /api/metrics/history: the router process's own
        history store (shared by every in-process replica — same
        registry, same sampler) plus each remote replica's store with
        series prefixed ``{replica_id}:`` and timestamps skew-corrected
        into the router's clock via the registry's ClockSync offsets —
        the same ``wall - offset`` convention as the fleet flight
        ledger, so stitched timelines and history lines agree."""
        local = obs.history.query(series=series, since=since, step=step)
        out_series: dict[str, Any] = dict(local["series"])
        offsets = self.registry.clock_offsets()
        replicas: list[str] = []
        for info in self.registry.alive(admitting=False):
            replicas.append(info.replica_id)
            if info.handle is None or isinstance(info.handle, LocalReplica):
                continue   # local replicas share the router's store
            try:
                remote = info.handle.history(
                    series=series, since=since, step=step
                )
            except Exception:  # noqa: BLE001 - degrade to survivors
                continue
            off = offsets.get(info.replica_id, 0.0)
            for name, s in remote.get("series", {}).items():
                out_series[f"{info.replica_id}:{name}"] = {
                    "kind": s.get("kind", "gauge"),
                    "points": [
                        [p[0] - off, p[1]]
                        for p in s.get("points", [])
                        if isinstance(p, (list, tuple)) and len(p) == 2
                    ],
                }
        return {
            "now": local["now"],
            "since": since,
            "step": step,
            "tiers": local["tiers"],
            "replicas": replicas,
            "clock_offset_s": offsets,
            "series": out_series,
        }

    def fleet_snapshot(self) -> dict[str, Any]:
        """GET /api/fleet: the registry view plus a per-replica SLO
        rollup and the router's session/ownership footprint."""
        self.registry.refresh_local()
        snap = self.registry.snapshot()
        for row in snap["replicas"]:
            info = self.registry.get(row["id"])
            if info is None or info.handle is None:
                continue
            try:
                verdicts = info.handle.slo().get("slos", [])
                row["slo"] = {
                    "pass": all(
                        v.get("pass") is not False for v in verdicts
                    ),
                    "slos": verdicts,
                }
            except Exception:  # noqa: BLE001
                row["slo"] = {"pass": None, "error": "unreachable"}
        with self._lock:
            snap["pinned_sessions"] = len(self._pins)
            snap["tracked_requests"] = len(self._participants)
        return snap

    def bench_rows(self) -> list[dict[str, Any]]:
        """GET /api/fleet/bench: bench-result-shaped rows assembled from
        each replica's live SLO values, so ``perf-check --url
        <router>`` (and scripts/perf_gate.py) can gate a running fleet
        with the same machinery that gates bench jsonl files."""
        rows: list[dict[str, Any]] = []
        for info in self.registry.alive(admitting=False):
            if info.handle is None:
                continue
            try:
                verdicts = info.handle.slo().get("slos", [])
            except Exception:  # noqa: BLE001
                continue
            for v in verdicts:
                val = v.get("value")
                if val is None:
                    continue
                unit = (v.get("unit") or "").lower()
                if unit not in ("ms", "s", "seconds") and "/s" not in unit:
                    # perf-check derives better/worse direction from the
                    # unit; a ratio row (error_rate) would gate backwards.
                    continue
                rows.append({
                    "metric": (
                        f"fleet_{v.get('name', '?')}[{info.replica_id}]"
                    ),
                    "value": val,
                    "unit": v.get("unit", ""),
                })
        return rows



# -- HTTP front-end -----------------------------------------------------------
# (method, path pattern, handler): the JAX package's router routes
# (``build_router_app``).
ROUTER_ROUTES = (
    ("POST", "/v1/chat/completions", "completions"),
    ("GET", "/v1/models", "models"),
    ("GET", "/healthz", "healthz"),
    ("GET", "/metrics", "metrics"),
    ("GET", "/api/slo", "slo_get"),
    ("GET", "/api/metrics/history", "history_get"),
    ("GET", "/api/fleet", "fleet_get"),
    ("GET", "/api/fleet/bench", "fleet_bench"),
    ("GET", "/api/fleet/directory", "directory_get"),
    ("GET", "/api/fleet/flight", "fleet_flight_get"),
    ("GET", "/api/timeline/{request_id}", "timeline_get"),
    ("POST", "/fleet/register", "register"),
    ("POST", "/fleet/heartbeat", "heartbeat"),
    ("POST", "/fleet/directory/lookup", "directory_lookup"),
    ("POST", "/fleet/deregister", "deregister"),
    ("POST", "/fleet/drain/{replica_id}", "drain"),
)
_INVALID = object()   # a request body that is not JSON


def build_router_app(
    router: FleetRouter, host: str = "127.0.0.1", port: int = 0,
) -> ThreadingHTTPServer:
    """The router's HTTP server bound to (host, port), port 0 picking a
    free one: the engine-server API plus the fleet control endpoints
    (register/heartbeat/deregister/drain, the directory lookup) and the
    fleet observability rollup, with the JAX app's routes, methods,
    statuses and JSON bodies. Call ``serve_forever`` on it."""
    from ..api import compile_routes, find_route

    compiled = compile_routes(ROUTER_ROUTES)

    class Handler(BaseHTTPRequestHandler):
        _status = 0

        def send_response(self, code: int, message: str | None = None) -> None:
            self._status = code
            super().send_response(code, message)

        def _send(self, status: int, data: bytes, ctype: str,
                  headers: dict[str, str] | None = None) -> None:
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def _reply(self, payload: Any, status: int = 200,
                   headers: dict[str, str] | None = None) -> None:
            self._send(status, json.dumps(payload).encode("utf-8"),
                       "application/json; charset=utf-8", headers)

        def _error(self, status: int, message: str) -> None:
            self._reply({"error": {"message": message}}, status)

        def _json(self) -> Any:
            """The request's JSON body, or ``_INVALID``."""
            try:
                length = int(self.headers.get("Content-Length", 0))
                return json.loads(self.rfile.read(length).decode("utf-8"))
            except (ValueError, UnicodeDecodeError):
                return _INVALID

        def _dispatch(self, method: str) -> None:
            url = urlsplit(self.path)
            query = {k: v[0] for k, v in parse_qs(url.query).items()}
            handler, params, label = find_route(compiled, method, url.path)
            if handler is not None:
                getattr(self, handler)(query, **params)
            elif label != "unmatched":
                self._send(405, b"405: Method Not Allowed", "text/plain; charset=utf-8")
            else:
                self._send(404, b"404: Not Found", "text/plain; charset=utf-8")

        def do_GET(self) -> None:  # noqa: N802 - http.server's name
            self._dispatch("GET")

        def do_POST(self) -> None:  # noqa: N802 - http.server's name
            self._dispatch("POST")

        def log_message(self, fmt: str, *args: Any) -> None:
            log.debug("%s " + fmt, self.address_string(), *args)

        # -- request plane ---------------------------------------------------
        def _err_response(self, e: Exception) -> None:
            status = e.status if isinstance(e, RequestError) else 500
            headers = {}
            retry_after = getattr(e, "retry_after_s", None)
            if status == 429 and retry_after is not None:
                headers["Retry-After"] = str(int(retry_after))
            self._reply({"error": {"message": str(e), "type": type(e).__name__}},
                        status, headers)

        def completions(self, query: dict[str, str]) -> None:
            body = self._json()
            if body is _INVALID:
                self._error(400, "invalid JSON body")
                return
            if not isinstance(body, dict) or not body.get("messages"):
                self._error(400, "messages is required")
                return
            force = query.get("replica") or None
            if body.get("stream"):
                self._stream(body, force)
                return
            try:
                out = router.complete(body, force_replica=force)
            except Exception as e:  # noqa: BLE001
                self._err_response(e)
                return
            self._reply(out)

        def _stream(self, body: dict[str, Any], force: str | None) -> None:
            gen = router.complete_stream(body, force_replica=force)
            try:
                first = next(gen, None)
            except Exception as e:  # noqa: BLE001
                self._err_response(e)
                return
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            self.close_connection = True
            chunk = first
            try:
                while chunk is not None:
                    self.wfile.write(b"data: " + json.dumps(chunk).encode("utf-8") + b"\n\n")
                    self.wfile.flush()
                    try:
                        chunk = next(gen, None)
                    except Exception as e:  # noqa: BLE001 - headers already sent
                        chunk = None
                        err = {"error": {"message": str(e)}}
                        self.wfile.write(b"data: " + json.dumps(err).encode("utf-8") + b"\n\n")
                self.wfile.write(b"data: [DONE]\n\n")
                self.wfile.flush()
            except OSError:
                # The client went away: writes fail, the generator's
                # cleanup runs (a write error is not the replica's).
                log.info("router stream client went away")
                gen.close()

        def models(self, query: dict[str, str]) -> None:
            seen: list[str] = []
            for info in router.registry.alive(admitting=False):
                if info.model and info.model not in seen:
                    seen.append(info.model)
            self._reply({
                "object": "list",
                "data": [{"id": m, "object": "model", "owned_by": "opsagent-fleet"}
                         for m in seen],
            })

        def healthz(self, query: dict[str, str]) -> None:
            router.registry.refresh_local()
            replicas = router.registry.all()
            out = {
                "status": "ok" if any(not r.draining for r in replicas) else "no_replicas",
                "role": "router",
                "replicas": len(replicas),
                "draining": sum(1 for r in replicas if r.draining),
                "prefill_lanes": sum(1 for r in replicas if r.role == "prefill"),
                "health": router.registry.health_snapshot(clock=True),
                "queued": sum(r.queue_depth() for r in replicas),
                "shed_queue_depth": router.shed_queue_depth,
                "directory": router.registry.directory.stats(),
            }
            if router.autoscaler is not None:
                out["autoscale"] = router.autoscaler.snapshot()
            if faults.active():
                out["faults"] = faults.summary()
            self._reply(out)

        def metrics(self, query: dict[str, str]) -> None:
            self._send(200, obs.metrics_text().encode("utf-8"), "text/plain; charset=utf-8")

        # -- fleet observability --------------------------------------------
        def fleet_get(self, query: dict[str, str]) -> None:
            self._reply(router.fleet_snapshot())

        def fleet_bench(self, query: dict[str, str]) -> None:
            self._reply(router.bench_rows())

        def slo_get(self, query: dict[str, str]) -> None:
            self._reply(router.slo_aggregate())

        def history_get(self, query: dict[str, str]) -> None:
            # Fleet-aggregated telemetry history: router-process series
            # plus replica-prefixed remote series, skew-corrected.
            try:
                kwargs = obs.history.parse_query(query)
            except ValueError as e:
                self._error(400, f"bad query: {e}")
                return
            self._reply(router.metrics_history(**kwargs))

        def timeline_get(self, query: dict[str, str], request_id: str) -> None:
            tl = router.timeline(request_id)
            if tl is None:
                self._error(404, "unknown request_id")
                return
            self._reply(tl)

        def directory_get(self, query: dict[str, str]) -> None:
            # Operator view (``fleet-kv``): the directory rows plus each
            # replica's tier footprint.
            router.registry.refresh_local()
            try:
                limit = int(query.get("limit", 256))
            except ValueError:
                limit = 256
            snap = router.registry.directory.snapshot(limit=limit)
            snap["replicas"] = [
                {
                    "id": info.replica_id,
                    "role": info.role,
                    "state": "draining" if info.draining else "active",
                    "digest_count": len(info.digests),
                    "digest_truncated": info.digest_truncated,
                    "host_pool_pages": info.load.get("host_pool_pages", 0),
                    "heartbeat_age_s": round(time.monotonic() - info.last_heartbeat, 3),
                }
                for info in router.registry.all()
            ]
            self._reply(snap)

        def fleet_flight_get(self, query: dict[str, str]) -> None:
            try:
                n = int(query.get("n", 256))
            except ValueError:
                n = 256
            self._reply(router.fleet_flight(
                n=n, kind=query.get("kind", ""), request_id=query.get("request_id", "")))

        # -- fleet control plane ----------------------------------------------
        def register(self, query: dict[str, str]) -> None:
            body = self._json()
            if body is _INVALID:
                self._error(400, "invalid JSON body")
                return
            rid = body.get("replica_id") or ""
            url = body.get("url") or ""
            if not rid or not url:
                self._error(400, "replica_id and url are required")
                return
            info = ReplicaInfo(
                replica_id=rid,
                model=body.get("model", ""),
                url=url,
                role=body.get("role", "decode"),
                capacity=int(body.get("capacity", 8)),
                page_size=int(body.get("page_size", 64)),
                mesh=dict(body.get("mesh") or {}),
                digests=set(body.get("digests") or ()),
                digest_truncated=bool(body.get("digest_truncated", False)),
                load=dict(body.get("load") or {}),
                handle=HttpReplica(url, rid),
            )
            router.registry.register(info)
            self._reply({
                "status": "registered", "replica_id": rid,
                "heartbeat_ttl_s": router.registry.ttl_s,
                # Echoed back on the next heartbeat: the registry's clock
                # offset and RTT estimate.
                "router_ts": time.time(),
            })

        def heartbeat(self, query: dict[str, str]) -> None:
            body = self._json()
            if body is _INVALID:
                self._error(400, "invalid JSON body")
                return
            ok = router.registry.heartbeat(
                body.get("replica_id", ""),
                load=body.get("load"),
                digests=body.get("digests"),
                digest_truncated=body.get("digest_truncated"),
                replica_ts=body.get("replica_ts"),
                echo_router_ts=body.get("echo_router_ts"),
                echo_held_s=body.get("echo_held_s"),
            )
            if not ok:
                # 410: reaped, or the router restarted: register again.
                self._error(410, "unknown replica; re-register")
                return
            self._reply({"status": "ok", "router_ts": time.time()})

        def directory_lookup(self, query: dict[str, str]) -> None:
            # A replica that missed locally asks which peers own these
            # chain keys; owners come back with their advertised URLs so
            # the replica fetches peer-to-peer (no page crosses the router).
            body = self._json()
            try:
                if body is _INVALID:
                    raise TypeError("invalid JSON body")
                keys = [str(k) for k in body.get("keys") or []]
            except (TypeError, AttributeError):
                self._error(400, "keys must be a string list")
                return
            asking = query.get("replica") or ""
            out: dict[str, list[dict[str, str]]] = {}
            for key, rids in router.registry.directory.owners(keys).items():
                owners = []
                for rid in rids:
                    if rid == asking:
                        continue
                    info = router.registry.get(rid)
                    if info is None or info.draining:
                        continue
                    owners.append({"id": rid, "url": info.url})
                if owners:
                    out[key] = owners
            self._reply({"owners": out})

        def deregister(self, query: dict[str, str]) -> None:
            body = self._json()
            if not isinstance(body, dict):
                body = {}
            router.registry.deregister(body.get("replica_id", ""))
            self._reply({"status": "ok"})

        def drain(self, query: dict[str, str], replica_id: str) -> None:
            try:
                out = router.drain(replica_id)
            except RequestError as e:
                self._error(e.status, str(e))
                return
            self._reply(out)

    return ThreadingHTTPServer((host, port), Handler)


def run_router_server(
    host: str = "0.0.0.0",
    port: int = 8090,
    tokenizer: str = "",
    model_name: str = "",
    affinity: bool = True,
    queue_spill: int | None = None,
    prefill_threshold: int = DEFAULT_PREFILL_THRESHOLD,
    heartbeat_ttl_s: float | None = None,
    max_retries: int = DEFAULT_MAX_RETRIES,
    hedge_queue_depth: int | None = None,
    shed_queue_depth: int | None = None,
    autoscale_snapshot: str = "",
    autoscale_max_replicas: int = 4,
    autoscale_port_base: int = 8400,
    autoscale_cooldown_s: float = 30.0,
) -> None:
    """``python -m opsagent_tpu_torch serve-router``: the fleet front-end as
    a process. The tokenizer (a tokenizer.json directory, or the byte
    tokenizer by default) must match the replicas': affinity scores hash
    token chains, so a mismatched tokenizer zeroes every score and
    placement falls back to least-loaded (correct, but cold).

    ``autoscale_snapshot`` (a ``snapshot create`` directory) turns on
    elastic scale-out: shed pressure launches standby replicas from the
    snapshot as local ``serve-engine`` subprocesses and promotes them into
    the decode set once request-ready; the scaler stops with the server."""
    from ..tokenizer import load_tokenizer

    router = FleetRouter(
        registry=ReplicaRegistry(ttl_s=heartbeat_ttl_s),
        affinity=affinity,
        queue_spill=queue_spill,
        prefill_threshold=prefill_threshold,
        tokenizer=load_tokenizer(tokenizer),
        model_family=model_name,
        max_retries=max_retries,
        hedge_queue_depth=hedge_queue_depth,
        shed_queue_depth=shed_queue_depth,
    )
    server = build_router_app(router, host, port)
    scaler = None
    if autoscale_snapshot:
        from .autoscale import Autoscaler, SubprocessLauncher

        launcher = SubprocessLauncher(
            snapshot_path=autoscale_snapshot,
            router_url=f"http://127.0.0.1:{server.server_address[1]}",
            port_base=autoscale_port_base,
        )
        scaler = Autoscaler(router, launcher, max_replicas=autoscale_max_replicas,
                            cooldown_s=autoscale_cooldown_s)
        router.autoscaler = scaler
        scaler.start()
    # The router samples its own process series (fleet shed/hedge/failover
    # rates) at 1 Hz behind /api/metrics/history.
    history = obs.history.get_history()
    history.start()
    log.info("fleet router listening on %s:%d", host, server.server_address[1])
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if scaler is not None:
            scaler.stop()
        server.server_close()
        history.stop()
