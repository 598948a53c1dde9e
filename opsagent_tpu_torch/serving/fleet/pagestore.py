"""Fleet-global KV page store: directory + peer-to-peer fault-in (the
port's copy of ``opsagent_tpu/serving/fleet/pagestore.py``).

PRs 7-10 made KV pages a per-replica asset the router papers over with
affinity scoring and explicit push-migration. This module inverts that:
the prefix digests every replica already heartbeats (Engine.prefix_digests
-> ReplicaInfo.digests) are indexed into a fleet-wide **directory** mapping
``chain_key_hex`` -> owning replicas, and a replica that misses locally at
admission (HBM trie AND host pool) consults the directory and **faults the
chain in** peer-to-peer over the existing ``/fleet/kv/export`` wire format
(transfer.pack_entries/unpack_entries, digest-verified). Fetched pages
land in the local HostPagePool under the identical chain keys, so the
admission restores them through the EXACT offload-restore path
(Engine._restore_from_host -> promote_prefix, a host-to-device page copy
ordered on the engine's stream): bit-exact, immediately
trie-visible, zero new restore code.

Tier order after this module: HBM trie -> host pool -> peer fetch ->
re-prefill. Every tier is an optimization over the next; correctness never
depends on a hit. The fetch client NEVER raises into admission — a miss,
a slow peer, an over-budget payload, or a corrupt record degrades to local
re-prefill, counted (``opsagent_pagestore_fallbacks_total``).

Staleness: directory rows are advertisements, not leases. A peer that no
longer holds an advertised chain (LRU-evicted between heartbeats, or a
404 / digest-reject on the fetch) is a **stale-entry signal**: the row is
evicted from the directory (``opsagent_pagestore_stale_entries_total``)
instead of retried — the next heartbeat re-advertises whatever the peer
really holds.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Callable

from ... import obs
from ...utils.logger import get_logger
from .. import faults
from ..offload.pool import chain_key_hex
from .transfer import records_nbytes, unpack_entries

log = get_logger("fleet.pagestore")

ENV_FETCH_TIMEOUT = "OPSAGENT_PAGESTORE_TIMEOUT_S"
DEFAULT_FETCH_TIMEOUT_S = 5.0

ENV_FETCH_MAX_BYTES = "OPSAGENT_PAGESTORE_MAX_BYTES"
DEFAULT_FETCH_MAX_BYTES = 256 << 20  # 256 MiB per fault-in

MAX_PEERS_PER_FAULT_IN = 2  # bounded: never a retry loop over the fleet


def fetch_timeout_s(override: float | None = None) -> float:
    if override is not None and override > 0:
        return float(override)
    try:
        v = float(os.environ.get(ENV_FETCH_TIMEOUT, ""))
        if v > 0:
            return v
    except ValueError:
        pass
    return DEFAULT_FETCH_TIMEOUT_S


def fetch_max_bytes(override: int | None = None) -> int:
    if override is not None and override > 0:
        return int(override)
    try:
        v = int(os.environ.get(ENV_FETCH_MAX_BYTES, ""))
        if v > 0:
            return v
    except ValueError:
        pass
    return DEFAULT_FETCH_MAX_BYTES


class PageDirectory:
    """chain_key_hex -> {replica_id: last_seen} index over heartbeat
    digests. Thread-safe; updated wholesale per replica (the heartbeat
    carries the replica's full advertisement, so an update is a set
    diff), invalidated row-wise on stale-entry signals and replica-wise
    on reap/deregister/drain."""

    def __init__(self):
        self._lock = threading.Lock()
        self._owners: dict[str, dict[str, float]] = {}
        self._by_replica: dict[str, set[str]] = {}
        # cumulative stats (registry snapshot + router /healthz)
        self.lookups = 0
        self.hits = 0
        self.misses = 0
        self.stale_evictions = 0

    # -- writes ------------------------------------------------------------
    def update(self, replica_id: str, keys: Any) -> None:
        """Replace ``replica_id``'s advertisement with ``keys``."""
        new = set(keys or ())
        now = time.monotonic()
        with self._lock:
            old = self._by_replica.get(replica_id, set())
            for k in old - new:
                owners = self._owners.get(k)
                if owners is not None:
                    owners.pop(replica_id, None)
                    if not owners:
                        del self._owners[k]
            for k in new:
                self._owners.setdefault(k, {})[replica_id] = now
            if new:
                self._by_replica[replica_id] = new
            else:
                self._by_replica.pop(replica_id, None)

    def remove_replica(self, replica_id: str) -> int:
        """Drop every row owned by ``replica_id`` (reap / deregister /
        drain). Returns rows removed."""
        with self._lock:
            keys = self._by_replica.pop(replica_id, set())
            n = 0
            for k in keys:
                owners = self._owners.get(k)
                if owners is not None and owners.pop(replica_id, None) \
                        is not None:
                    n += 1
                    if not owners:
                        del self._owners[k]
            return n

    def invalidate(self, key: str, replica_id: str) -> bool:
        """Stale-entry eviction: the peer advertised ``key`` but could
        not produce it (evicted, 404, digest reject). Evict the single
        row — the replica's other advertisements stay valid."""
        with self._lock:
            owners = self._owners.get(key)
            if owners is None or owners.pop(replica_id, None) is None:
                return False
            if not owners:
                del self._owners[key]
            rep = self._by_replica.get(replica_id)
            if rep is not None:
                rep.discard(key)
            self.stale_evictions += 1
            return True

    # -- reads -------------------------------------------------------------
    def owners(self, keys: list[str]) -> dict[str, list[str]]:
        """Owning replica ids per chain key, freshest advertisement
        first. Counts lookup hit/miss stats per key."""
        out: dict[str, list[str]] = {}
        with self._lock:
            for k in keys:
                self.lookups += 1
                owners = self._owners.get(k)
                if owners:
                    self.hits += 1
                    out[k] = [
                        rid for rid, _ in sorted(
                            owners.items(), key=lambda kv: -kv[1]
                        )
                    ]
                else:
                    self.misses += 1
        return out

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {
                "chains": len(self._owners),
                "replicas": len(self._by_replica),
                "lookups": self.lookups,
                "hits": self.hits,
                "misses": self.misses,
                "stale_evictions": self.stale_evictions,
            }

    def snapshot(self, limit: int = 256) -> dict[str, Any]:
        """Operator view (GET /api/fleet/directory, ``fleet-kv``):
        per-chain owners with advertisement staleness."""
        now = time.monotonic()
        with self._lock:
            rows = [
                {
                    "chain": k,
                    "owners": [
                        {"id": rid, "age_s": round(now - seen, 3)}
                        for rid, seen in sorted(
                            owners.items(), key=lambda kv: -kv[1]
                        )
                    ],
                }
                for k, owners in list(self._owners.items())[:limit]
            ]
            truncated = len(self._owners) > limit
        return {
            "stats": self.stats(),
            "rows": rows,
            "truncated": truncated,
        }


class PageStoreClient:
    """The fault-in side: resolve missing chain keys against the
    directory, fetch the pages peer-to-peer, land them in the local host
    pool. Composed from three callables so in-process fleets (router-
    owned directory + LocalReplica handles) and HTTP fleets (router
    lookup endpoint + peer engine servers) share one implementation:

        lookup(keys)          -> {key: [owner, ...]}   owner: {"id", ...}
        fetch(owner, tokens, start_page, timeout_s) -> transfer records
        template()            -> any pytree with the local cache treedef

    ``fault_in`` NEVER raises: admission calls it inline, and every
    failure mode (no owner, timeout, oversized payload, digest reject)
    degrades to local re-prefill, counted."""

    def __init__(
        self,
        self_id: str,
        page_size: int,
        pool: Any,
        template: Callable[[], Any],
        lookup: Callable[[list[str]], dict[str, list[dict[str, Any]]]],
        fetch: Callable[..., list[dict[str, Any]]],
        on_stale: Callable[[str, str], None] | None = None,
        timeout_s: float | None = None,
        max_bytes: int | None = None,
    ):
        self.self_id = self_id
        self.page_size = page_size
        self.pool = pool
        self.template = template
        self.lookup = lookup
        self.fetch = fetch
        self.on_stale = on_stale
        self.timeout_s = fetch_timeout_s(timeout_s)
        self.max_bytes = fetch_max_bytes(max_bytes)
        # cumulative stats (tests / bench read the deltas)
        self.remote_hit_pages = 0
        self.fallbacks = 0
        self.stale_entries = 0

    # -- internals ---------------------------------------------------------
    def _note_stale(self, key: str, replica_id: str) -> None:
        self.stale_entries += 1
        obs.PAGESTORE_STALE_ENTRIES.inc()
        if self.on_stale is not None:
            try:
                self.on_stale(key, replica_id)
            except Exception:  # noqa: BLE001 - bookkeeping only
                log.exception("stale-entry eviction callback failed")

    def _fallback(self, reason: str, **ctx: Any) -> int:
        self.fallbacks += 1
        obs.PAGESTORE_FALLBACKS.inc(reason=reason)
        obs.flight.record(
            "page_fault_in", phase="exit", outcome="fallback",
            reason=reason, replica=self.self_id, **ctx,
        )
        return 0

    def fault_in(
        self, token_ids: list[int], start_page: int,
        request_id: str = "",
    ) -> int:
        """Fetch pages ``start_page..`` of ``token_ids`` (a page-aligned
        usable prefix) from peers into the local host pool. Returns
        pages landed (0 on any failure — the caller re-prefills).
        ``request_id`` tags the flight events with the journey this
        fetch serves so the fleet stitcher can draw the fault-in
        window."""
        try:
            return self._fault_in(token_ids, start_page, request_id)
        except Exception:  # noqa: BLE001 - NEVER raises into admission
            log.exception("page fault-in failed; re-prefilling")
            return self._fallback(
                "error",
                **({"request_id": request_id} if request_id else {}),
            )

    def _fault_in(
        self, token_ids: list[int], start_page: int,
        request_id: str = "",
    ) -> int:
        P = self.page_size
        total = len(token_ids) // P
        if start_page >= total:
            return 0
        missing = {
            chain_key_hex(token_ids[: (i + 1) * P]): i
            for i in range(start_page, total)
        }
        keys = list(missing)
        rid_field = {"request_id": request_id} if request_id else {}
        obs.PAGESTORE_LOOKUPS.inc(len(keys))
        try:
            owners_map = self.lookup(keys)
        except Exception:  # noqa: BLE001 - directory unreachable
            log.exception("pagestore directory lookup failed")
            return self._fallback(
                "lookup_error", chains=len(keys), **rid_field
            )
        # Rank candidate peers by how many missing chains they cover
        # (the deepest-coverage owner almost always holds the whole
        # suffix — chains are prefixes of each other).
        coverage: dict[str, int] = {}
        owner_info: dict[str, dict[str, Any]] = {}
        claims: dict[str, list[str]] = {}
        for key, owners in owners_map.items():
            for o in owners:
                rid = o.get("id") if isinstance(o, dict) else str(o)
                if rid == self.self_id or rid is None:
                    continue
                coverage[rid] = coverage.get(rid, 0) + 1
                owner_info.setdefault(
                    rid, o if isinstance(o, dict) else {"id": rid}
                )
                claims.setdefault(rid, []).append(key)
        if not coverage:
            return self._fallback(
                "no_owner", chains=len(keys), **rid_field
            )
        ranked = sorted(coverage, key=lambda r: -coverage[r])
        obs.flight.record(
            "page_fault_in", phase="enter", replica=self.self_id,
            chains=len(keys), start_page=start_page,
            candidates=len(ranked), **rid_field,
        )
        t0 = time.perf_counter()
        landed = 0
        nbytes = 0
        outcome = "miss"
        for rid in ranked[:MAX_PEERS_PER_FAULT_IN]:
            try:
                faults.maybe_raise(
                    "pagestore.fetch_timeout", TimeoutError,
                    "injected pagestore fetch timeout",
                    peer=rid, replica=self.self_id,
                )
                records = self.fetch(
                    owner_info[rid], token_ids,
                    start_page + landed, self.timeout_s,
                )
            except urllib.error.HTTPError as e:
                if e.code == 404:
                    # Gone peer endpoint / unknown chain: stale signal,
                    # evict the rows — do NOT retry this peer.
                    for key in claims.get(rid, ()):
                        self._note_stale(key, rid)
                    continue
                log.warning("pagestore fetch from %s failed: %s", rid, e)
                self.fallbacks += 1
                obs.PAGESTORE_FALLBACKS.inc(reason="error")
                continue
            except (TimeoutError, OSError) as e:
                log.warning("pagestore fetch from %s timed out: %s", rid, e)
                self.fallbacks += 1
                obs.PAGESTORE_FALLBACKS.inc(reason="timeout")
                continue
            except Exception:  # noqa: BLE001
                log.exception("pagestore fetch from %s failed", rid)
                self.fallbacks += 1
                obs.PAGESTORE_FALLBACKS.inc(reason="error")
                continue
            if faults.fire(
                "pagestore.stale_entry", peer=rid, replica=self.self_id
            ):
                records = []   # injected: the peer evicted the chain
            if not records:
                # The directory said this peer owns the chain; the peer
                # says it does not (LRU eviction between the heartbeat
                # and the fetch). Stale rows evict — no retry loop.
                for key in claims.get(rid, ()):
                    self._note_stale(key, rid)
                continue
            got = records_nbytes(records)
            while records and got > self.max_bytes:
                # Size bound: drop tail records (deepest pages) until
                # the payload fits — a partial chain still restores its
                # leading pages; the rest re-prefills.
                got -= records_nbytes(records[-1:])
                records = records[:-1]
            unpacked = unpack_entries(records, self.template())
            if records and not unpacked:
                # Every record digest-rejected: corrupt peer — same
                # stale-entry treatment as a 404.
                for key in claims.get(rid, ()):
                    self._note_stale(key, rid)
                continue
            for toks, tree in unpacked:
                if self.pool.put(toks, tree):
                    landed += 1
            nbytes += got
            if landed:
                outcome = "hit"
            if start_page + landed >= total:
                break
        dt = time.perf_counter() - t0
        if landed:
            self.remote_hit_pages += landed
            obs.PAGESTORE_REMOTE_HITS.inc(landed)
            obs.PAGESTORE_FETCH_BYTES.inc(nbytes)
        elif outcome == "miss":
            self.fallbacks += 1
            obs.PAGESTORE_FALLBACKS.inc(reason="miss")
        obs.PAGESTORE_FETCH_SECONDS.observe(dt)
        if request_id:
            obs.FLEET_HOP_SECONDS.observe(dt, hop="fault_in")
        obs.flight.record(
            "page_fault_in", phase="exit", outcome=outcome,
            replica=self.self_id, pages=landed, bytes=nbytes,
            ms=round(dt * 1e3, 3), **rid_field,
        )
        return landed

    def stats(self) -> dict[str, int]:
        return {
            "remote_hit_pages": self.remote_hit_pages,
            "fallbacks": self.fallbacks,
            "stale_entries": self.stale_entries,
        }


# -- client factories ---------------------------------------------------------
def local_client(registry: Any, self_id: str, engine: Any) -> PageStoreClient:
    """Fault-in client for an in-process replica: the router's registry
    owns the directory, peer handles are LocalReplica objects reachable
    through it. Wired by FleetRouter.add_local."""

    def lookup(keys: list[str]) -> dict[str, list[dict[str, Any]]]:
        return {
            k: [{"id": rid} for rid in rids]
            for k, rids in registry.directory.owners(keys).items()
        }

    def fetch(
        owner: dict[str, Any], token_ids: list[int],
        start_page: int, timeout_s: float,
    ) -> list[dict[str, Any]]:
        info = registry.get(owner["id"])
        if info is None or info.handle is None:
            return []
        return info.handle.export_pages(
            token_ids, park=False, start_page=start_page,
        )

    return PageStoreClient(
        self_id=self_id,
        page_size=int(engine.cfg.page_size),
        pool=engine.offload.pool,
        template=lambda: engine.cache,
        lookup=lookup,
        fetch=fetch,
        on_stale=registry.directory.invalidate,
    )


def http_client(
    router_url: str, self_id: str, engine: Any,
) -> PageStoreClient:
    """Fault-in client for a ``serve-engine --join-fleet`` replica: the
    directory lives router-side (POST /fleet/directory/lookup returns
    owners WITH their advertised URLs); pages fetch peer-to-peer from
    the owning replica's /fleet/kv/export — the router never carries
    page payloads."""
    base = router_url.rstrip("/")

    def _post(
        url: str, body: dict[str, Any], timeout_s: float,
    ) -> dict[str, Any]:
        req = urllib.request.Request(
            url, data=json.dumps(body).encode("utf-8"),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(  # noqa: S310 - operator URLs
            req, timeout=timeout_s
        ) as resp:
            return json.loads(resp.read().decode("utf-8"))

    def lookup(keys: list[str]) -> dict[str, list[dict[str, Any]]]:
        out = _post(
            base + "/fleet/directory/lookup", {"keys": keys},
            timeout_s=fetch_timeout_s(),
        )
        return out.get("owners", {})

    def fetch(
        owner: dict[str, Any], token_ids: list[int],
        start_page: int, timeout_s: float,
    ) -> list[dict[str, Any]]:
        url = (owner.get("url") or "").rstrip("/")
        if not url:
            return []
        out = _post(
            url + "/fleet/kv/export",
            {
                "chains": [
                    {"tokens": token_ids, "start_page": start_page}
                ],
                "park": False,
            },
            timeout_s=timeout_s,
        )
        results = out.get("results")
        if results:
            return results[0].get("pages", [])
        return out.get("pages", [])   # pre-batching engine servers

    return PageStoreClient(
        self_id=self_id,
        page_size=int(engine.cfg.page_size),
        pool=engine.offload.pool,
        template=lambda: engine.cache,
        lookup=lookup,
        fetch=fetch,
    )
