"""Replica-to-replica KV page transfer: the wire format of session
migration and page fault-in (the port's counterpart of
``opsagent_tpu/serving/fleet/transfer.py``, byte-compatible with it in both
directions).

The wire format is the host pool's keying (``offload/pool.py``): each page
carries the full page-aligned token chain whose KV it holds and its leaves,
each as its dtype as numpy spells it (``"bfloat16"`` too), its shape and its
bytes in base64, in the JAX package's flatten order, with a blake2b-16
digest over the tokens and the payloads. The receiver rebuilds the host
page against its own cache's leaves and inserts it under the same chain key,
so the next admission of that history restores through the local host-tier
path. bf16 leaves travel as their raw 16-bit words: the port has no numpy
bfloat16, so it writes ``view(torch.int16)`` bytes and reads them back
through ``torch.frombuffer(..., dtype=torch.bfloat16)``.

A record whose leaf count does not match the local cache, whose payload
does not decode, or whose digest does not match is rejected, counted and
anomaly-dumped: the receiver then re-prefills, it never restores corrupt KV.
"""

from __future__ import annotations

import base64
import hashlib
import logging
from typing import Any

import numpy as np
import torch

from ... import obs
from ...models.convert import DTYPE_NAMES, leaf_bytes
from ..offload.pool import HostPage, HostTree

log = logging.getLogger("opsagent_tpu_torch.fleet.transfer")

_DTYPES = {v: k for k, v in DTYPE_NAMES.items()}


def _record_digest(tokens: np.ndarray, blobs: list[bytes]) -> str:
    """Integrity digest over a record's chain tokens and payload bytes,
    computed by the sender and checked by the receiver."""
    h = hashlib.blake2b(digest_size=16)
    h.update(np.asarray(tokens, np.int32).tobytes())
    for blob in blobs:
        h.update(blob)
    return h.hexdigest()


def pack_entries(entries: list[HostPage]) -> list[dict[str, Any]]:
    """Host pool entries -> JSON-safe transfer records (chain tokens,
    per-leaf dtype, shape and base64 data, integrity digest)."""
    out: list[dict[str, Any]] = []
    for e in entries:
        leaves = list(e.data.values())
        blobs = [leaf_bytes(t) for t in leaves]
        tokens = np.asarray(e.tokens, np.int32)
        out.append({
            "tokens": tokens.tolist(),
            "digest": _record_digest(tokens, blobs),
            "leaves": [
                {"dtype": DTYPE_NAMES[t.dtype], "shape": list(t.shape),
                 "data": base64.b64encode(blob).decode("ascii")}
                for t, blob in zip(leaves, blobs)
            ],
        })
    return out


def _reject(rec: dict[str, Any], reason: str, **extra: Any) -> None:
    """Drop a corrupt or malformed record: counted, anomaly-dumped, and it
    costs the receiver only a re-prefill."""
    obs.FLEET_KV_IMPORT_REJECTS.inc()
    obs.flight.anomaly("kv_import_reject", cause=reason,
                       tokens=len(rec.get("tokens") or ()), **extra)
    log.warning("rejecting KV import record (%s); receiver re-prefills", reason)


def unpack_entries(records: list[dict[str, Any]], template: Any) -> list[tuple[list[int], HostTree]]:
    """Transfer records -> [(chain tokens, host page)] named after
    ``template``'s leaves (the engine's ``PagedKVCache``; its shapes are
    not read). A record is checked before it is kept: its leaf count
    against the cache's, its payload, and its digest when it has one
    (records of older senders have none). The fleet's fault injection
    (``transfer.truncate`` / ``transfer.corrupt``) comes with ROADMAP item
    13(b)."""
    names = list(template.page_leaves())
    out: list[tuple[list[int], HostTree]] = []
    for rec in records:
        specs = list(rec.get("leaves") or [])
        if len(names) != len(specs):
            _reject(rec, "structure_mismatch", record_leaves=len(specs),
                    local_leaves=len(names))
            continue
        try:
            blobs = [base64.b64decode(s["data"]) for s in specs]
        except (KeyError, ValueError, TypeError) as e:
            _reject(rec, "undecodable_payload", error=str(e)[:120])
            continue
        digest = rec.get("digest")
        if digest is not None:
            got = _record_digest(np.asarray(rec.get("tokens") or [], np.int32), blobs)
            if got != digest:
                _reject(rec, "digest_mismatch", expected=digest, got=got)
                continue
        try:
            tree = {
                name: torch.frombuffer(bytearray(blob), dtype=_DTYPES[s["dtype"]])
                .reshape(s["shape"])
                for name, s, blob in zip(names, specs, blobs)
            }
        except (KeyError, ValueError, TypeError, RuntimeError) as e:
            _reject(rec, "malformed_leaf", error=str(e)[:120])
            continue
        out.append(([int(t) for t in rec["tokens"]], tree))
    return out


def records_nbytes(records: list[dict[str, Any]]) -> int:
    """Decoded payload bytes of a transfer (3/4 of the base64 length)."""
    return sum((len(s.get("data", "")) * 3) // 4
               for rec in records for s in rec.get("leaves", ()))

# migrate_chain (one chain shipped from a source replica to a destination
# through the router's handles) comes with the router, ROADMAP item 13(b).
