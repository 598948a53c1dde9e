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

``migrate_chain`` ships one token chain between two replica handles
(``fleet/router.py``): the source parks or copies the chain's pages into its
host pool under its engine lock, on its engine's stream, and packs them; the
destination checks them and puts them in its pool, where its next admission
of the chain restores them. Records carry whole pages at any mesh: a
tp-sharded engine's pool holds its ranks' heads side by side.
"""

from __future__ import annotations

import base64
import hashlib
import logging
import time
from typing import Any

import numpy as np
import torch

from ... import obs
from ...models.convert import DTYPE_NAMES, leaf_bytes
from .. import faults
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
    (records of older senders have none). The fault points
    ``transfer.truncate`` (the last leaf lost in transit) and
    ``transfer.corrupt`` (one payload bit flipped) fire here, as in the JAX
    package."""
    names = list(template.page_leaves())
    out: list[tuple[list[int], HostTree]] = []
    for rec in records:
        specs = list(rec.get("leaves") or [])
        if faults.fire("transfer.truncate", tokens=len(rec.get("tokens") or ())):
            specs = specs[:-1]   # injected: last leaf lost in transit
        if len(names) != len(specs):
            _reject(rec, "structure_mismatch", record_leaves=len(specs),
                    local_leaves=len(names))
            continue
        try:
            blobs = [base64.b64decode(s["data"]) for s in specs]
        except (KeyError, ValueError, TypeError) as e:
            _reject(rec, "undecodable_payload", error=str(e)[:120])
            continue
        if blobs and faults.fire("transfer.corrupt", tokens=len(rec.get("tokens") or ())):
            b = bytearray(blobs[0])      # injected: flip one payload bit
            b[len(b) // 2] ^= 0x01
            blobs[0] = bytes(b)
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


def migrate_chain(
    src: Any, dst: Any, token_ids: list[int], reason: str,
    session: str = "", park: bool = True, request_id: str = "",
) -> int:
    """Ship one token chain's KV pages from replica handle ``src`` to
    ``dst`` (``fleet/router.py``). With ``park`` the source first evicts the
    chain from its HBM trie into its host pool (``Engine.park_chain``);
    otherwise it copies what the trie holds (``replicate_chain``). Returns
    pages shipped, 0 on any failure: migration rides on a correct
    re-prefill, so it never raises into routing. An engine on a mesh of
    several ranks ships and takes whole pages, as a one-rank engine does
    (its host pool holds them, ``offload/copy.py``). ``request_id`` tags
    the ``session_migrate`` flight events with the journey the transfer
    serves."""
    t0 = time.perf_counter()
    rid_field = {"request_id": request_id} if request_id else {}
    obs.flight.record(
        "session_migrate", phase="enter", reason=reason, session=session,
        src=getattr(src, "replica_id", "?"), dst=getattr(dst, "replica_id", "?"),
        tokens=len(token_ids), **rid_field,
    )
    pages = nbytes = 0
    err = ""
    try:
        records = src.export_pages(token_ids, park=park)
        if records:
            pages = dst.import_pages(records)
            nbytes = records_nbytes(records)
    except Exception as e:  # noqa: BLE001 - re-prefill covers correctness
        err = str(e)
        log.exception("chain migration failed (receiver will re-prefill)")
    dt = time.perf_counter() - t0
    if pages:
        obs.FLEET_MIGRATIONS.inc(reason=reason)
        obs.FLEET_TRANSFER_PAGES.inc(pages)
        obs.FLEET_TRANSFER_BYTES.inc(nbytes)
        obs.FLEET_TRANSFER_SECONDS.observe(dt)
    if request_id:
        obs.FLEET_HOP_SECONDS.observe(dt, hop="migrate")
    obs.flight.record(
        "session_migrate", phase="exit", reason=reason, session=session,
        src=getattr(src, "replica_id", "?"), dst=getattr(dst, "replica_id", "?"),
        pages=pages, bytes=nbytes, ms=round(dt * 1e3, 3),
        **({"error": err} if err else {}), **rid_field,
    )
    return pages
