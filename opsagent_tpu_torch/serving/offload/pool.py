"""Host-RAM KV page pool: tier 2 of the hierarchical KV cache (the port's
copy of ``opsagent_tpu/serving/offload/pool.py``).

Entries are keyed exactly like the HBM prefix trie, by the page-aligned
token chain whose KV the page holds, so the pool is a host-RAM extension of
the trie: ``match`` walks the way ``PageAllocator.match_prefix`` does, and a
chain restored from here re-registers into the trie
(``PageAllocator.promote_prefix``) so that partial restores still hit for
concurrent admissions.

A page's content is a *host page*: the cache's leaves with the page axis
removed, CPU tensors in the JAX package's flatten order (``k``, ``v``; for
int8 pages ``k.q``, ``k.scale``, ``v.q``, ``v.scale``; for the MLA latent
layout the latent ``k`` and its ``[L, P, 1, 1]`` placeholder ``v``), held in
a dict of that order; on the card each leaf is a pinned block that the
page's gather landed in (``copy.py``). The chain digest is the JAX package's blake2b-16 over
the int32 tokens, so both packages name every chain alike.

The pool is byte-bounded (``OPSAGENT_KV_HOST_POOL_BYTES``, default 1 GiB):
inserting past the bound drops least-recently-used entries. Dropping a
mid-chain entry orphans the pages behind it (``match`` stops at the first
miss); orphans age out by the same LRU. Correctness never depends on
residency: a miss means the tokens re-prefill.

Thread safety: one lock around the index. Payloads are immutable once
inserted.
"""

from __future__ import annotations

import hashlib
import os
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

ENV_HOST_POOL_BYTES = "OPSAGENT_KV_HOST_POOL_BYTES"
DEFAULT_HOST_POOL_BYTES = 1 << 30  # 1 GiB

# A host page: leaf name -> CPU tensor, in the JAX package's flatten order.
HostTree = dict[str, torch.Tensor]


def host_pool_capacity_bytes(override: int | None = None) -> int:
    """Resolve the pool byte bound: explicit override > env > default."""
    if override is not None and override > 0:
        return int(override)
    raw = os.environ.get(ENV_HOST_POOL_BYTES, "")
    try:
        v = int(raw)
        if v > 0:
            return v
    except ValueError:
        pass
    return DEFAULT_HOST_POOL_BYTES


def _chain_key(tokens: np.ndarray) -> bytes:
    """Digest of the full token prefix this page chain covers. The digest
    is the dict key; the entry stores the tokens for verification, so a
    hash collision can never alias two histories' KV."""
    return hashlib.blake2b(
        np.ascontiguousarray(tokens, dtype=np.int32).tobytes(), digest_size=16
    ).digest()


def chain_key_hex(tokens) -> str:
    """Public form of the chain digest (hex), shared with the fleet layer:
    a replica advertises these keys as its prefix digest and the KV wire
    format carries the token chains under them."""
    return _chain_key(np.asarray(tokens, dtype=np.int32)).hex()


def tree_nbytes(data: HostTree) -> int:
    """Tensor bytes of a host page."""
    return sum(t.numel() * t.element_size() for t in data.values())


@dataclass
class HostPage:
    """One offloaded page: the KV content of ``tokens[-page_size:]`` given
    the preceding context ``tokens[:-page_size]``."""

    tokens: np.ndarray          # int32 [n_pages * page_size] full prefix
    data: HostTree              # one cache page, CPU tensors
    nbytes: int = 0
    last_use: int = 0
    key: bytes = field(default=b"", repr=False)


class HostPagePool:
    def __init__(self, page_size: int, capacity_bytes: int | None = None):
        self.page_size = page_size
        self.capacity_bytes = host_pool_capacity_bytes(capacity_bytes)
        self._lock = threading.Lock()
        self._entries: dict[bytes, HostPage] = {}
        self._clock = 0
        self.used_bytes = 0
        # Cumulative stats (the opsagent_kv_host_pool_* gauges and the
        # allocator's accounting()).
        self.inserts = 0
        self.hits = 0        # pages served by match()
        self.misses = 0      # match() walks ended by a missing page
        self.drops = 0       # LRU drops under the byte bound
        self.rejects = 0     # single pages larger than the whole bound

    # -- writing -----------------------------------------------------------
    def put(self, tokens: list[int] | np.ndarray, data: HostTree) -> bool:
        """Insert one page: ``tokens`` is the full page-aligned prefix (its
        last page_size tokens are the ones this page holds), ``data`` the
        page's host tree. Returns False when rejected (oversized or
        unaligned)."""
        toks = np.ascontiguousarray(tokens, dtype=np.int32)
        if toks.size == 0 or toks.size % self.page_size != 0:
            return False
        nbytes = tree_nbytes(data)
        if nbytes > self.capacity_bytes:
            with self._lock:
                self.rejects += 1
            return False
        key = _chain_key(toks)
        with self._lock:
            self._clock += 1
            old = self._entries.get(key)
            if old is not None:
                # The same chain offloaded again: refresh its recency and
                # keep the first payload, so that restores stay stable.
                old.last_use = self._clock
                return True
            self._entries[key] = HostPage(
                tokens=toks, data=data, nbytes=nbytes,
                last_use=self._clock, key=key,
            )
            self.used_bytes += nbytes
            self.inserts += 1
            self._enforce_bound_locked()
        return True

    def _enforce_bound_locked(self) -> None:
        while self.used_bytes > self.capacity_bytes and self._entries:
            victim = min(self._entries.values(), key=lambda e: e.last_use)
            del self._entries[victim.key]
            self.used_bytes -= victim.nbytes
            self.drops += 1

    # -- reading -----------------------------------------------------------
    def match(
        self,
        tokens: list[int] | np.ndarray,
        start_page: int = 0,
        max_pages: int | None = None,
    ) -> list[HostPage]:
        """Longest resident page chain covering ``tokens`` from page
        ``start_page`` (the pages before it are the HBM trie's). Returns
        the entries in chain order; empty when the first is absent."""
        toks = np.ascontiguousarray(tokens, dtype=np.int32)
        P = self.page_size
        out: list[HostPage] = []
        with self._lock:
            self._clock += 1
            stamp = self._clock
            for i in range(start_page, toks.size // P):
                if max_pages is not None and len(out) >= max_pages:
                    break
                ent = self._entries.get(_chain_key(toks[: (i + 1) * P]))
                if ent is None or not np.array_equal(ent.tokens, toks[: (i + 1) * P]):
                    self.misses += 1
                    break
                ent.last_use = stamp
                out.append(ent)
            self.hits += len(out)
        return out

    def coverage(self, tokens: list[int] | np.ndarray, start_page: int = 0) -> int:
        """How many consecutive pages of ``tokens`` from ``start_page`` are
        resident, without touching recency or the hit/miss counts."""
        toks = np.ascontiguousarray(tokens, dtype=np.int32)
        P = self.page_size
        n = 0
        with self._lock:
            for i in range(start_page, toks.size // P):
                ent = self._entries.get(_chain_key(toks[: (i + 1) * P]))
                if ent is None or not np.array_equal(ent.tokens, toks[: (i + 1) * P]):
                    break
                n += 1
        return n

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.used_bytes = 0

    def digests(self) -> list[str]:
        """Hex chain keys of every resident page (the host-tier half of a
        replica's prefix digest)."""
        with self._lock:
            return [k.hex() for k in self._entries]

    # -- accounting --------------------------------------------------------
    @property
    def num_pages(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {
                "pages": len(self._entries),
                "bytes": self.used_bytes,
                "capacity_bytes": self.capacity_bytes,
                "inserts": self.inserts,
                "hits": self.hits,
                "misses": self.misses,
                "drops": self.drops,
                "rejects": self.rejects,
            }
