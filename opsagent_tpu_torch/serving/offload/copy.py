"""Device<->host KV page copies: the data plane of the offload tier (the
port's counterpart of ``opsagent_tpu/serving/offload/copy.py``).

- **gather** (device -> host): ``index_select`` of the page ids from every
  cache leaf (``PagedKVCache.page_leaves``, never the scratch slot) into
  the bucket's device staging buffer, page-major (``[b, L, P, ...]``), then
  one non-blocking copy a page into its own pinned host block and an event.
  Those blocks are the host pages the pool keeps: nothing is copied again
  on the host. ``flush`` lands the copies whose events are done (``wait``
  waits for them all), so a spill costs its enqueue and the pull overlaps
  the ticks that follow.
- **scatter** (host -> device): a non-blocking copy a page from its pinned
  block (a pageable one, as the wire delivers, is pinned first) into the
  staging buffer, then ``index_copy_`` into the cache views in place. The
  cache's tensors are never reassigned: the captured step graphs hold
  their addresses.

Pinned blocks come from PyTorch's caching host allocator: a host page
dropped from the pool returns its block for the next spill, so after
warm-up a spill neither pins nor faults in host memory.

Both run under inference mode (the cache's tensors are inference tensors)
and on the engine's stream, so a spill's gather, enqueued inside
``allocate``, precedes any later write to the recycled page, and a
restore's scatter precedes the tick that reads the pages. Page-id vectors
pad to a bucket of ``(1, copy_pages)`` by repeating the first real id, as
in JAX. On the CPU the same code runs without pinning or events.

At a mesh of several ranks (``parallel.mesh``) the host pool holds whole
pages, as the JAX package's does: a tp-sharded cache leaf holds K/tp kv
heads (axis 3 of ``[L, N, P, K, D]``, and of the int8 scale planes ``[L, N,
P, K]``), so a whole page is the ranks' slices side by side in tp order.
Every rank runs each copy at the same point of the engine's step order
(``Engine._device``):

- a gather all-gathers each leaf's staged slices over ``tp`` before the
  leader's pinned copies are enqueued, so a pull's event stands behind
  every rank's bytes; followers keep nothing;
- a scatter fills a whole-page staging buffer on the leader, broadcasts it
  from the leader over the job's default group, and each rank writes its
  own heads of it. The page data rides the collective, never the step
  record.

The MLA latent cache, and any cache at tp = 1, is whole on every rank:
there the leader's own copy is the page and a scatter's broadcast carries
it to the others.

The copies are plain data movement: the JAX package does them in XLA
(``jnp.take``, ``.at[].set``), not in a Pallas kernel.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Any

import torch

from ... import obs
from ...parallel.collectives import all_gather, broadcast_from_leader
from ...parallel.mesh import AXES, Mesh
from .pool import HostTree

_PAGE_AXIS = 1  # cache leaves are [L, num_pages, page_size, ...]
_HEAD_AXIS = 3  # of a page-major staging buffer [b, L, P, K, ...]


@dataclass
class _Pull:
    """One dispatched gather: ``pages[j]``, the host page of real page j,
    is being copied; ``metas[j]`` rides with it; ``event`` is recorded
    after the copies (None on the CPU)."""

    metas: list[Any]
    pages: list[HostTree]
    event: Any
    nbytes: int


class PageCopyEngine:
    """``mesh``: the engine's mesh (None or one rank: a one-rank engine)."""

    def __init__(self, copy_pages: int = 8, mesh: Mesh | None = None):
        copy_pages = max(1, int(copy_pages))
        self.buckets = (1,) if copy_pages == 1 else (1, copy_pages)
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self._pending: deque[_Pull] = deque()
        # (bucket, leaf name, whole) -> device staging buffer [bucket, L,
        # P, ...], of this rank's heads or (whole) of every rank's. Reused
        # by every copy of its bucket: one stream orders them.
        self._staging: dict[tuple[int, str, bool], torch.Tensor] = {}

    @property
    def leader(self) -> bool:
        """Whether this rank keeps the host pages (the only rank, or the
        mesh's global rank 0)."""
        return self.mesh is None or self.mesh.leader

    def _tp(self, cache: Any) -> int:
        """The number of head shards a whole page of ``cache`` is cut into
        on this mesh (1: every rank holds whole pages)."""
        if self.mesh is None or getattr(cache, "latent", False):
            return 1
        return self.mesh.shape[AXES.tp]

    def fits(self, cache: Any, tree: HostTree) -> bool:
        """Whether a host page matches ``cache``'s whole pages (``[L, P,
        ...]`` with every rank's heads, the pool's and the wire format's
        shape at any mesh): its leaves' names, order, shapes and dtypes
        (checked before a restore is published to the ranks)."""
        leaves = cache.page_leaves()
        if list(tree) != list(leaves):
            return False
        for name, leaf in leaves.items():
            shape = [leaf.shape[0], *leaf.shape[2:]]
            shape[_HEAD_AXIS - 1] *= self._tp(cache)
            if tuple(tree[name].shape) != tuple(shape) or tree[name].dtype != leaf.dtype:
                return False
        return True

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _chunks(self, pages: list[int], device: torch.device):
        """(offset, chunk, bucket, padded ids on ``device``). The ids reach
        the card through pinned memory, without a stream-wide sync."""
        for off in range(0, len(pages), self.buckets[-1]):
            chunk = pages[off: off + self.buckets[-1]]
            b = self._bucket(len(chunk))
            ids = torch.full((b,), chunk[0], dtype=torch.int64)
            ids[: len(chunk)] = torch.tensor(chunk, dtype=torch.int64)
            if device.type == "cuda":
                ids = ids.pin_memory().to(device, non_blocking=True)
            yield off, chunk, b, ids

    def _stage(self, b: int, name: str, leaf: torch.Tensor, tp: int = 1) -> torch.Tensor:
        """The bucket's page-major staging buffer of one leaf (with ``tp`` >
        1, of its whole pages): persistent on the card, a new tensor on
        the CPU."""
        shape = [b, leaf.shape[0], *leaf.shape[2:]]
        shape[_HEAD_AXIS] *= tp
        if leaf.device.type != "cuda":
            return torch.empty(shape, dtype=leaf.dtype)
        buf = self._staging.get((b, name, tp > 1))
        if buf is None:
            buf = torch.empty(shape, dtype=leaf.dtype, device=leaf.device)
            self._staging[(b, name, tp > 1)] = buf
        return buf

    # -- device -> host ----------------------------------------------------
    @torch.inference_mode()
    def dispatch_gather(self, cache: Any, pages: list[int], metas: list[Any]) -> None:
        """Enqueue device->host copies of ``pages`` (chunked into buckets).
        ``metas[j]`` rides along to ``flush`` with page ``pages[j]``. At a
        mesh every rank calls it with the same pages: each leaf's slices
        are all-gathered over tp, and only the leader enqueues host copies
        (a follower's ``metas`` are not read)."""
        if len(pages) != len(metas):
            raise ValueError(f"{len(pages)} pages but {len(metas)} metas")
        leaves = cache.page_leaves()
        device = next(iter(leaves.values())).device
        pin = device.type == "cuda"
        tp = self._tp(cache)
        for off, chunk, b, ids in self._chunks(pages, device):
            host: list[HostTree] = [{} for _ in chunk]
            for name, leaf in leaves.items():
                stage = self._stage(b, name, leaf)
                torch.index_select(leaf.transpose(0, _PAGE_AXIS), 0, ids, out=stage)
                if tp > 1:
                    stage = all_gather(stage, self.mesh, AXES.tp, dim=_HEAD_AXIS)
                if not self.leader:
                    continue
                for j, tree in enumerate(host):
                    # Pinned on the card; raises when it cannot be had.
                    h = torch.empty(stage.shape[1:], dtype=stage.dtype, pin_memory=pin)
                    h.copy_(stage[j], non_blocking=pin)
                    tree[name] = h
            if not self.leader:
                continue
            event = None
            if pin:
                event = torch.cuda.Event()
                event.record()
            nbytes = sum(t.numel() * t.element_size() for tree in host for t in tree.values())
            self._pending.append(_Pull(metas[off: off + len(chunk)], host, event, nbytes))

    def flush(self, wait: bool = True) -> list[tuple[Any, HostTree]]:
        """Land pending gathers in dispatch order: every one with ``wait``,
        else only those whose copies are done (a copy behind a tick still
        in flight stays pending, so the tick is not waited for). Returns
        (meta, host page) pairs; a host page's leaves are ``[L, P, ...]``.
        The bytes and wall time feed the goodput ledger (kind "other")."""
        out: list[tuple[Any, HostTree]] = []
        t0 = time.perf_counter()
        nbytes = 0
        while self._pending:
            pull = self._pending[0]
            if pull.event is not None:
                if wait:
                    pull.event.synchronize()
                elif not pull.event.query():
                    break
            self._pending.popleft()
            nbytes += pull.nbytes
            out.extend(zip(pull.metas, pull.pages))
        if out:
            obs.attribution.record_copy(nbytes, "gather", seconds=time.perf_counter() - t0)
        return out

    @property
    def pending_pages(self) -> int:
        return sum(len(p.metas) for p in self._pending)

    def pending_metas(self) -> list[Any]:
        return [m for p in self._pending for m in p.metas]

    # -- host -> device ----------------------------------------------------
    def scatter(self, cache: Any, pages: list[int], page_trees: list[HostTree] | None) -> None:
        """Write host pages into device ``pages`` in place, chunked into
        buckets; the bytes and wall time feed the goodput ledger. At a
        mesh every rank calls it with the same pages, and a follower's
        ``page_trees`` is None: its heads come from the leader's."""
        if not pages or (page_trees is not None and len(pages) != len(page_trees)):
            raise ValueError(f"{len(pages)} pages for "
                             f"{None if page_trees is None else len(page_trees)} host pages")
        if page_trees is None and self.leader:
            raise ValueError("the leader scatters host pages it holds")
        t0 = time.perf_counter()
        self._scatter(cache, pages, page_trees)
        if page_trees is not None:
            nbytes = sum(t.numel() * t.element_size()
                         for tree in page_trees for t in tree.values())
            obs.attribution.record_copy(nbytes, "scatter", seconds=time.perf_counter() - t0)

    @torch.inference_mode()
    def _scatter(self, cache: Any, pages: list[int], page_trees: list[HostTree] | None) -> None:
        """A padding lane repeats the first real page id with that page's
        own content, so the duplicated ``index_copy_`` indices write
        identical bytes and the result is defined."""
        leaves = cache.page_leaves()
        device = next(iter(leaves.values())).device
        pin = device.type == "cuda"
        tp = self._tp(cache)
        for off, chunk, b, ids in self._chunks(pages, device):
            for name, leaf in leaves.items():
                stage = self._stage(b, name, leaf, tp)
                if page_trees is not None:
                    trees = page_trees[off: off + len(chunk)]
                    for j, tree in enumerate(trees):
                        src = tree[name]
                        if pin and not src.is_pinned():
                            src = src.pin_memory()
                        stage[j].copy_(src, non_blocking=pin)
                    stage[len(trees):] = stage[0]
                if self.mesh is not None:
                    stage = broadcast_from_leader(stage, self.mesh)
                if tp > 1:
                    k = stage.shape[_HEAD_AXIS] // tp
                    stage = stage.narrow(_HEAD_AXIS, self.mesh.coords[AXES.tp] * k, k)
                leaf.index_copy_(_PAGE_AXIS, ids, stage.transpose(0, _PAGE_AXIS))

    def warm(self, cache: Any) -> None:
        """Allocate every bucket's staging buffers and pinned blocks by a
        gather and a scatter of page 0 that leave its content as it was.
        Records no copy in the ledger. At a mesh every rank calls it."""
        pending, self._pending = self._pending, deque()
        try:
            for b in self.buckets:
                self.dispatch_gather(cache, [0] * b, [None] * b)
                pages = None
                if self.leader:
                    pull = self._pending.popleft()
                    if pull.event is not None:
                        pull.event.synchronize()
                    pages = pull.pages
                self._scatter(cache, [0] * b, pages)
        finally:
            self._pending = pending
