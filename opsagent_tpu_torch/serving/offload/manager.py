"""Offload policy and telemetry: ties the host pool and the copy engine to
one engine's cache and allocator (the port's counterpart of
``opsagent_tpu/serving/offload/manager.py``).

Every entry point runs under the engine lock. The manager never raises
into the serving path: a failed spill loses only a future restore (the
tokens re-prefill), and a failed restore falls back to re-prefill.

At a mesh the leader's manager is the tier: its pool holds whole pages and
its digests, coverage and counters are the replica's. The engine runs its
spills and restores as device ops (``Engine._op_spill``, ``_op_restore``),
where each follower's copier gathers or writes its own heads.
"""

from __future__ import annotations

import logging
import time
from typing import Any

import numpy as np

from ... import obs
from .copy import PageCopyEngine
from .pool import HostPage, HostPagePool, tree_nbytes

log = logging.getLogger("opsagent_tpu_torch.offload")


class OffloadManager:
    def __init__(self, pool: HostPagePool, copier: PageCopyEngine, page_size: int):
        self.pool = pool
        self.copier = copier
        self.page_size = page_size
        # Cumulative restore stats.
        self.restored_tokens = 0
        self.restored_pages = 0
        self.spilled_pages = 0
        # Restored tokens whose pages came from a peer rather than a local
        # spill (the fleet's page fault-in; stays 0 until the port has it).
        self.remote_hit_tokens = 0
        self._drops_seen = 0

    # -- device -> host (spill) --------------------------------------------
    def spill(self, cache: Any, chains: list[tuple[int, list[int]]],
              trigger: str = "evict") -> int:
        """Enqueue device->host copies for ``(page, token_chain)`` pairs;
        the chain is the full page-aligned token prefix the page's KV
        covers (the host-pool key). The pages land at a later ``flush``.
        Returns the number of pages dispatched."""
        good_pages: list[int] = []
        metas: list[tuple[int, ...]] = []
        for page, chain in chains:
            if not chain or len(chain) % self.page_size != 0:
                continue
            good_pages.append(page)
            metas.append(tuple(chain))
        if not good_pages:
            return 0
        try:
            self.copier.dispatch_gather(cache, good_pages, metas)
        except Exception:  # noqa: BLE001 - offload is best-effort
            log.exception("page spill dispatch failed (content lost to host tier)")
            return 0
        self.spilled_pages += len(good_pages)
        obs.OFFLOAD_PAGES.inc(len(good_pages), dir="out")
        obs.flight.record("offload", pages=len(good_pages), trigger=trigger)
        return len(good_pages)

    def pending_for(self, tokens: list[int]) -> bool:
        """Whether a spill still in flight holds a page of ``tokens``' chain
        (an admission of ``tokens`` must then wait for it)."""
        n = len(tokens)
        return any(len(c) <= n and list(c) == tokens[: len(c)]
                   for c in self.copier.pending_metas())

    def flush(self, wait: bool = True) -> int:
        """Land pending spills in the host pool: all of them with ``wait``,
        else those whose copies are done. Returns pages landed."""
        if self.copier.pending_pages == 0:
            self._observe()
            return 0
        n = 0
        nbytes = 0
        try:
            for chain, page_tree in self.copier.flush(wait=wait):
                if self.pool.put(np.asarray(chain, np.int32), page_tree):
                    n += 1
                    nbytes += tree_nbytes(page_tree)
        except Exception:  # noqa: BLE001 - offload is best-effort
            log.exception("offload flush failed")
        if nbytes:
            obs.OFFLOAD_BYTES.inc(nbytes, dir="out")
        self._observe()
        return n

    # -- host -> device (restore) ------------------------------------------
    def restore(self, cache: Any, dst_pages: list[int], entries: list[HostPage],
                seq_id: int | None = None) -> int:
        """Scatter host pool entries into freshly allocated device pages,
        in place. Returns the tokens restored."""
        if not entries:
            return 0
        t0 = time.perf_counter()
        self.copier.scatter(cache, dst_pages, [e.data for e in entries])
        dt = time.perf_counter() - t0
        tokens = len(entries) * self.page_size
        self.restored_pages += len(entries)
        self.restored_tokens += tokens
        obs.OFFLOAD_PAGES.inc(len(entries), dir="in")
        obs.OFFLOAD_BYTES.inc(sum(e.nbytes for e in entries), dir="in")
        obs.OFFLOAD_RESTORE_SECONDS.observe(dt)
        obs.OFFLOAD_REPREFILL_AVOIDED.inc(tokens)
        obs.flight.record("restore", seq_id=seq_id, pages=len(entries), tokens=tokens,
                          ms=round(dt * 1e3, 3))
        self._observe()
        return tokens

    # -- telemetry ---------------------------------------------------------
    def _observe(self) -> None:
        st = self.pool.stats()
        obs.HOST_POOL_BYTES.set(float(st["bytes"]))
        obs.HOST_POOL_PAGES.set(float(st["pages"]))
        obs.HOST_POOL_CAPACITY.set(float(st["capacity_bytes"]))
        if st["drops"] > self._drops_seen:
            obs.HOST_POOL_DROPS.inc(st["drops"] - self._drops_seen)
            self._drops_seen = st["drops"]

    def stats(self) -> dict[str, Any]:
        return {
            **self.pool.stats(),
            "restored_pages": self.restored_pages,
            "restored_tokens": self.restored_tokens,
            "spilled_pages": self.spilled_pages,
            "remote_hit_tokens": self.remote_hit_tokens,
            "pending_pages": self.copier.pending_pages,
        }
