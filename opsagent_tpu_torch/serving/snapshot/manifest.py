"""Snapshot manifest: the on-disk contract of an engine snapshot (the port's
copy of ``opsagent_tpu/serving/snapshot/manifest.py``: the same format
version, file names, fingerprint and digests, so that each package verifies
the other's snapshots).

A snapshot directory is::

    <path>/
      manifest.json        # written LAST: its presence marks completion
      weights/leaf-00000.bin ...   # raw leaf bytes in spec-tree order
      compile-cache/...    # the JAX package's XLA compile cache, or the
                           # port's built kernel libraries

The manifest records a blake2b **fingerprint** over the (model config,
engine config) pair plus a per-leaf digest, so ``snapshot verify`` and the
restore path can refuse a snapshot that does not match what the restoring
engine would build: a mismatched page geometry or quantize mode would
otherwise surface as a shape error deep inside the weight load.

This module is stdlib only, so ``snapshot verify`` runs on any machine.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any

MANIFEST_NAME = "manifest.json"
WEIGHTS_DIR = "weights"
COMPILE_CACHE_DIR = "compile-cache"
FORMAT_VERSION = 1

_DIGEST_SIZE = 16
_CHUNK = 1 << 22  # 4 MiB digest read chunks


class SnapshotError(RuntimeError):
    """A snapshot is missing, corrupt, or mismatched with this engine."""


def digest_bytes(data: bytes) -> str:
    return hashlib.blake2b(data, digest_size=_DIGEST_SIZE).hexdigest()


def digest_file(path: str) -> str:
    h = hashlib.blake2b(digest_size=_DIGEST_SIZE)
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_CHUNK)
            if not chunk:
                break
            h.update(chunk)
    return h.hexdigest()


def fingerprint(model: dict[str, Any], engine: dict[str, Any]) -> str:
    """Identity of the (model architecture, engine shape-config) pair:
    canonical-JSON blake2b over the two serialized dicts. Anything that
    changes compiled program shapes or the sharded weight layout must be
    in one of them; anything that does not (seed, checkpoint path,
    warmup flag) must not — else identical snapshots would refuse to
    restore over an irrelevant knob."""
    payload = json.dumps(
        {"model": model, "engine": engine},
        sort_keys=True, ensure_ascii=False,
    )
    return digest_bytes(payload.encode("utf-8"))


def write_manifest(path: str, man: dict[str, Any]) -> None:
    """Atomic write (tmp + rename): a torn manifest must never exist —
    its presence is the snapshot-complete marker."""
    target = os.path.join(path, MANIFEST_NAME)
    tmp = target + ".tmp"
    with open(tmp, "w") as f:
        json.dump(man, f, indent=1, sort_keys=True)
    os.replace(tmp, target)


def read_manifest(path: str) -> dict[str, Any]:
    target = os.path.join(path, MANIFEST_NAME)
    try:
        with open(target) as f:
            man = json.load(f)
    except OSError as e:
        raise SnapshotError(
            f"not a snapshot directory (no readable {MANIFEST_NAME}): "
            f"{path} ({e})"
        ) from e
    except json.JSONDecodeError as e:
        raise SnapshotError(f"corrupt manifest {target}: {e}") from e
    if not isinstance(man, dict) or "fingerprint" not in man:
        raise SnapshotError(f"malformed manifest {target}")
    if man.get("format") != FORMAT_VERSION:
        raise SnapshotError(
            f"snapshot format {man.get('format')!r} != supported "
            f"{FORMAT_VERSION} ({target})"
        )
    return man


def verify_snapshot(path: str, quick: bool = False) -> dict[str, Any]:
    """Integrity report for ``opsagent snapshot verify``: recompute the
    config fingerprint and every leaf file's size (+ content digest
    unless ``quick``). Pure-host check — no jax, no device."""
    man = read_manifest(path)
    errors: list[str] = []
    fp = fingerprint(man.get("model", {}), man.get("engine", {}))
    fingerprint_ok = fp == man["fingerprint"]
    if not fingerprint_ok:
        errors.append(
            f"fingerprint mismatch: manifest says {man['fingerprint']}, "
            f"configs hash to {fp} (manifest edited or corrupt)"
        )
    leaves = man.get("leaves", [])
    leaves_ok = 0
    for rec in leaves:
        fpath = os.path.join(path, rec["file"])
        if not os.path.exists(fpath):
            errors.append(f"missing leaf file {rec['file']}")
            continue
        size = os.path.getsize(fpath)
        if size != rec["nbytes"]:
            errors.append(
                f"{rec['file']}: {size} bytes on disk, manifest says "
                f"{rec['nbytes']}"
            )
            continue
        if not quick and digest_file(fpath) != rec["digest"]:
            errors.append(f"{rec['file']}: content digest mismatch")
            continue
        leaves_ok += 1
    cache = man.get("compile_cache", {})
    cache_entries_found = 0
    cache_dir = os.path.join(path, COMPILE_CACHE_DIR)
    if os.path.isdir(cache_dir):
        for _root, _dirs, files in os.walk(cache_dir):
            cache_entries_found += len(files)
    if cache.get("entries", 0) and cache_entries_found == 0:
        errors.append(
            f"manifest records {cache['entries']} compile-cache entries "
            f"but {COMPILE_CACHE_DIR}/ is missing or empty"
        )
    return {
        "ok": not errors,
        "path": path,
        "fingerprint": man["fingerprint"],
        "fingerprint_ok": fingerprint_ok,
        "model": man.get("model", {}).get("name", ""),
        "leaves": len(leaves),
        "leaves_ok": leaves_ok,
        "compile_cache_entries": cache_entries_found,
        "errors": errors,
    }
