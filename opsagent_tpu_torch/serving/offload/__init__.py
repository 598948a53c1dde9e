"""Hierarchical KV cache: the host-RAM offload tier (the port's counterpart
of ``opsagent_tpu/serving/offload``).

The HBM ``PageAllocator`` trie (``serving/kvcache.py``) is tier 1; this
package is tier 2, a bounded host-RAM pool of evicted or parked KV page
content, with the device<->host page copies and the policy that decides
when pages move. A session whose pages were evicted under HBM pressure, or
parked while its ReAct loop blocks on a tool, restores them with a page
copy instead of re-running prefill.

- ``pool``: ``HostPagePool``, the token-chain-keyed host page store with a
  byte-bounded LRU (``OPSAGENT_KV_HOST_POOL_BYTES``).
- ``copy``: ``PageCopyEngine``, the gather and scatter between the cache's
  page views and pinned host memory, in page-count buckets.
- ``manager``: ``OffloadManager``, which ties pool and copier to one
  engine's cache and allocator and owns the spill, restore and park flows
  and their telemetry.
"""

from __future__ import annotations

from .copy import PageCopyEngine  # noqa: F401
from .manager import OffloadManager  # noqa: F401
from .pool import (  # noqa: F401
    DEFAULT_HOST_POOL_BYTES,
    ENV_HOST_POOL_BYTES,
    HostPagePool,
    chain_key_hex,
    host_pool_capacity_bytes,
)
