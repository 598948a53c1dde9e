"""Host-side paged KV-cache bookkeeping, with prefix caching (the port's
copy of ``opsagent_tpu/serving/kvcache.py``, without the host-offload tier).

The device holds the pages (``models.llama.PagedKVCache``); this module owns
the free list, per-sequence page tables, and the **prefix trie**: finished
sequences donate their full pages (keyed by page-aligned token content) so a
later request whose prompt shares the prefix skips re-prefilling it. The
ReAct loop re-sends the whole chat history every iteration (reference
pkg/assistants/simple.go:497-515) — prefix reuse turns that O(n²) re-prefill
into O(n) (SURVEY.md §5 checkpoint note, §7 step 5).

States of a page:
- **free**: on the free list.
- **owned**: exclusively held by a live sequence (its tail / generated pages).
- **shared**: in the trie with refcount = number of live sequences using it.
- **cached**: in the trie with refcount 0 — content retained, evictable LRU
  when the free list runs dry.

Allocation is O(pages) against a free list plus O(prompt/page_size) trie
walks; page counts are small (thousands).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field

import numpy as np


class OutOfPages(Exception):
    """No free KV pages right now; the scheduler should queue the request."""


class PromptTooLong(Exception):
    """The request can NEVER be admitted (exceeds max_pages_per_seq or the
    largest prefill bucket); fail fast instead of queueing."""


class InvalidRequest(ValueError):
    """Malformed request (client's fault, HTTP 400) — distinct from engine
    bugs that happen to raise ValueError, which must stay 5xx."""


@dataclass
class SeqAlloc:
    seq_id: int
    pages: list[int] = field(default_factory=list)
    length: int = 0          # tokens currently in cache
    num_shared: int = 0      # leading pages borrowed from the prefix trie


@dataclass
class TrieNode:
    """One cached page: identified by (parent page, its page of tokens)."""

    page: int
    parent: int                      # parent page id, or -1 at the root
    key: tuple[int, ...]             # the page_size tokens this page holds
    refcount: int = 0                # live sequences sharing this page
    children: int = 0                # child nodes (only leaves are evictable)
    last_use: int = 0                # LRU stamp


class PageAllocator:
    def __init__(
        self,
        num_pages: int,
        page_size: int,
        max_pages_per_seq: int,
        prefix_cache: bool = True,
    ):
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_pages_per_seq = max_pages_per_seq
        self.prefix_cache = prefix_cache
        self._free: list[int] = list(range(num_pages - 1, -1, -1))
        self._seqs: dict[int, SeqAlloc] = {}
        self._next_id = 0
        # Prefix trie: (parent_page, token_tuple) -> TrieNode; page -> node.
        self._trie: dict[tuple[int, tuple[int, ...]], TrieNode] = {}
        self._by_page: dict[int, TrieNode] = {}
        self._clock = itertools.count()
        self.hit_tokens = 0   # cumulative prefix-cache hits (stats)
        self.miss_tokens = 0
        self.evictions = 0    # cumulative trie-leaf evictions (stats)

    # -- queries -----------------------------------------------------------
    def accounting(self) -> dict[str, int]:
        """Page-conservation snapshot: every page is exactly one of free,
        trie-resident (shared or cached), or exclusively owned by a live
        sequence — so free + trie + owned == num_pages always. The
        concurrency stress test asserts this under load (the Python answer
        to the reference's missing `go test -race`, SURVEY section 5)."""
        owned = sum(
            len(s.pages) - s.num_shared for s in self._seqs.values()
        )
        return {
            "free": len(self._free),
            "trie": len(self._by_page),
            "owned": owned,
            "total": len(self._free) + len(self._by_page) + owned,
        }

    def pages_needed(self, num_tokens: int) -> int:
        return -(-num_tokens // self.page_size)

    def length(self, seq_id: int) -> int:
        return self._seqs[seq_id].length

    # -- prefix trie -------------------------------------------------------
    def match_prefix(self, tokens: list[int]) -> list[int]:
        """Longest cached page-aligned prefix of ``tokens``; returns the page
        ids WITHOUT taking references (call ``allocate`` with the result)."""
        if not self.prefix_cache:
            return []
        P = self.page_size
        stamp = next(self._clock)
        pages: list[int] = []
        parent = -1
        for i in range(len(tokens) // P):
            node = self._trie.get((parent, tuple(tokens[i * P:(i + 1) * P])))
            if node is None:
                break
            node.last_use = stamp  # matched chains are fresh, not LRU bait
            pages.append(node.page)
            parent = node.page
        return pages

    def _take_free_page(self) -> int:
        """Pop a free page, evicting the LRU unreferenced trie leaf if the
        free list is dry. Raises OutOfPages when nothing is evictable."""
        if self._free:
            return self._free.pop()
        victim: TrieNode | None = None
        for node in self._by_page.values():
            if node.refcount == 0 and node.children == 0:
                if victim is None or node.last_use < victim.last_use:
                    victim = node
        if victim is None:
            raise OutOfPages("no free pages and no evictable cached pages")
        self._evict(victim)
        return self._free.pop()

    def _evict(self, node: TrieNode) -> None:
        self.evictions += 1
        del self._trie[(node.parent, node.key)]
        del self._by_page[node.page]
        if node.parent >= 0 and node.parent in self._by_page:
            self._by_page[node.parent].children -= 1
        self._free.append(node.page)

    def _register_pages(self, seq: SeqAlloc, tokens: list[int]) -> list[int]:
        """Donate a finished sequence's full pages to the trie; returns the
        pages to put back on the free list (duplicates of already-cached
        content, the partial last page, over-allocated pages). ``tokens`` =
        the sequence's full token history (prompt + generated).

        Invariant: pages[0:num_shared] ARE trie nodes we hold a reference on
        (matched at admission against these exact tokens), so the walk just
        releases those references; owned full pages either become new trie
        nodes (kept) or are duplicates of a concurrently-registered chain
        (freed)."""
        P = self.page_size
        stamp = next(self._clock)
        full_pages = min(len(tokens) // P, len(seq.pages))
        absorbed: set[int] = set()
        parent = -1
        for i in range(full_pages):
            key = tuple(tokens[i * P:(i + 1) * P])
            page = seq.pages[i]
            if i < seq.num_shared:
                node = self._by_page[page]   # we hold a ref: cannot be evicted
                node.refcount -= 1
                node.last_use = stamp
                parent = page
                continue
            node = self._trie.get((parent, key))
            if node is not None:
                # Same content already cached by someone else: our page is a
                # duplicate — follow the canonical chain, free ours.
                node.last_use = stamp
                parent = node.page
                continue
            node = TrieNode(page=page, parent=parent, key=key, last_use=stamp)
            self._trie[(parent, key)] = node
            self._by_page[page] = node
            if parent >= 0 and parent in self._by_page:
                self._by_page[parent].children += 1
            absorbed.add(page)
            parent = page
        # Shared pages past the registered walk (can happen only if tokens
        # shrank, which callers never do — defensive deref).
        for i in range(full_pages, seq.num_shared):
            node = self._by_page.get(seq.pages[i])
            if node is not None:
                node.refcount -= 1
        return [
            p for i, p in enumerate(seq.pages)
            if i >= seq.num_shared and p not in absorbed
        ]

    # -- lifecycle ---------------------------------------------------------
    def allocate(
        self, num_tokens: int, prefix_pages: list[int] | None = None
    ) -> int:
        """Allocate pages for a new sequence of ``num_tokens``, reusing
        ``prefix_pages`` (from ``match_prefix``) for its head. Returns
        seq_id. Raises OutOfPages when the pool is exhausted."""
        prefix_pages = prefix_pages or []
        need_total = self.pages_needed(max(1, num_tokens))
        if need_total > self.max_pages_per_seq:
            raise PromptTooLong(
                f"sequence needs {need_total} pages > max_pages_per_seq="
                f"{self.max_pages_per_seq} "
                f"({self.max_pages_per_seq * self.page_size} tokens)"
            )
        shared = [p for p in prefix_pages if p in self._by_page][
            : need_total
        ]
        # Reference the shared chain BEFORE popping fresh pages: with the
        # refcounts at 0 the matched pages themselves would be LRU-eviction
        # candidates while _take_free_page hunts for fresh ones — handing
        # the same physical page out as both prefix and tail.
        for p in shared:
            node = self._by_page[p]
            node.refcount += 1
            node.last_use = next(self._clock)
        need_fresh = need_total - len(shared)
        fresh: list[int] = []
        try:
            for _ in range(need_fresh):
                fresh.append(self._take_free_page())
        except OutOfPages:
            self._free.extend(fresh)
            for p in shared:
                self._by_page[p].refcount -= 1
            raise
        seq = SeqAlloc(self._next_id)
        self._next_id += 1
        seq.pages = shared + fresh
        seq.num_shared = len(shared)
        seq.length = num_tokens
        self._seqs[seq.seq_id] = seq
        self.hit_tokens += len(shared) * self.page_size
        self.miss_tokens += max(
            0, num_tokens - len(shared) * self.page_size
        )
        return seq.seq_id

    def extend(self, seq_id: int, new_tokens: int = 1) -> None:
        """Account for appended tokens, growing by a page when crossing a
        boundary. Raises OutOfPages when the pool is exhausted (caller may
        preempt another sequence and retry)."""
        seq = self._seqs[seq_id]
        target = seq.length + new_tokens
        while len(seq.pages) * self.page_size < target:
            if len(seq.pages) >= self.max_pages_per_seq:
                raise OutOfPages(f"seq {seq_id} hit max_pages_per_seq")
            seq.pages.append(self._take_free_page())
        seq.length = target

    def extend_upto(self, seq_id: int, want: int) -> int:
        """Best-effort ``extend``: grow by as many of ``want`` tokens as the
        per-seq cap and page pool allow; returns the number granted (0 when
        the sequence cannot grow at all). Used by block decode to pre-book
        pages for a whole dispatch, then ``truncate`` back what the device
        did not use."""
        seq = self._seqs[seq_id]
        got = min(want, len(seq.pages) * self.page_size - seq.length)
        seq.length += got
        while got < want:
            if len(seq.pages) >= self.max_pages_per_seq:
                break
            try:
                seq.pages.append(self._take_free_page())
            except OutOfPages:
                break
            take = min(want - got, self.page_size)
            seq.length += take
            got += take
        return got

    def truncate(self, seq_id: int, new_length: int) -> None:
        """Shrink a sequence's accounted length (block-decode rollback of
        pre-booked-but-unused tokens), releasing whole pages that fall past
        the new length. Never touches shared (prefix-trie) pages: truncation
        targets are >= the prompt length, whose pages cover the shared
        chain."""
        seq = self._seqs[seq_id]
        if new_length > seq.length:
            raise ValueError(
                f"truncate to {new_length} > current length {seq.length}"
            )
        seq.length = new_length
        keep = max(self.pages_needed(max(1, new_length)), seq.num_shared)
        while len(seq.pages) > keep:
            self._free.append(seq.pages.pop())

    def free(self, seq_id: int, tokens: list[int] | None = None) -> None:
        """Release a sequence. With ``tokens`` (its full token history) and
        prefix caching on, full pages are donated to the trie instead of
        freed; shared pages are dereferenced either way."""
        seq = self._seqs.pop(seq_id, None)
        if seq is None:
            return
        if self.prefix_cache and tokens is not None:
            self._free.extend(self._register_pages(seq, tokens))
        else:
            for i, p in enumerate(seq.pages):
                if i < seq.num_shared:
                    node = self._by_page.get(p)
                    if node is not None:
                        node.refcount -= 1
                else:
                    self._free.append(p)

    # -- device views ------------------------------------------------------
    def page_table_row(self, seq_id: int) -> np.ndarray:
        """This sequence's page table padded to max_pages_per_seq with -1."""
        row = np.full((self.max_pages_per_seq,), -1, np.int32)
        pages = self._seqs[seq_id].pages
        row[: len(pages)] = pages
        return row

    def batch_views(
        self, seq_ids: list[int], batch_size: int
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(page_table [batch, MaxP], lengths [batch], active [batch]) for a
        decode batch; unused slots are inactive with empty tables."""
        table = np.full((batch_size, self.max_pages_per_seq), -1, np.int32)
        lengths = np.zeros((batch_size,), np.int32)
        active = np.zeros((batch_size,), bool)
        for i, sid in enumerate(seq_ids):
            if sid is None:
                continue
            table[i] = self.page_table_row(sid)
            lengths[i] = self._seqs[sid].length
            active[i] = True
        return table, lengths, active
