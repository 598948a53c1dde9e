"""Snapshot writer: an engine's restart artifact (the port's counterpart of
``opsagent_tpu/serving/snapshot/writer.py``).

What it writes:

- **Weights in the JAX package's leaf layout**: one file per leaf of the
  JAX parameter tree, in its flatten order (``models.convert.jax_leaves``),
  under its keystr ``path``, with the layers stacked on a leading axis as
  JAX holds them (the port keeps JAX's orientation, so stacking is all the
  conversion there is; a layer is written straight after the one before,
  so nothing is stacked in memory). The same files restore in either
  package.
- **The kernel libraries**: the built ``.so`` of every current kernel
  source (``ops.cuda_build``), under ``compile-cache/``: the port's
  counterpart of the XLA compile cache. A restore pre-seeds them, so the
  restored engine runs no ``nvcc``. CUDA graphs are not written: warmup
  captures them anew.
- **The paged-KV plan**: page geometry and cache leaf shapes; the cache is
  rebuilt empty.

The manifest (``manifest.py``, shared format) is written last: its
presence marks a complete snapshot. Its ``engine`` block holds the JAX
package's fingerprint fields (the mesh axes as the engine resolved them),
and a ``torch`` block the torch version, the device, the paged-attention
kernels and the mesh, as the JAX package's ``jax`` block records its own.

At a mesh of several ranks every rank runs the writer (``Engine``'s
``snapshot`` op): each leaf, one layer at a time, is all-gathered whole
from the ranks' shards (``Llama.full_tensor``, by ``state_specs``:
columns, rows and the vocab over tp, experts over ep), and the leader
writes it. The files are the bytes a one-rank engine of the same weights
writes; the host never holds more than one layer's leaf.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import logging
import os
import shutil
import time
from typing import Any

import torch

from ... import obs
from ...models.convert import DTYPE_NAMES, jax_leaves, leaf_bytes
from ...models.llama import DecoderLayer
from ...ops import cuda_build
from .manifest import COMPILE_CACHE_DIR, FORMAT_VERSION, WEIGHTS_DIR, fingerprint, write_manifest

log = logging.getLogger("opsagent_tpu_torch.snapshot")

# The JAX package's fingerprint fields of EngineConfig: whatever changes
# program shapes or the weight layout.
ENGINE_FINGERPRINT_FIELDS = (
    "model", "tokenizer", "tp", "dp", "sp", "ep",
    "speculative_k", "speculative_ngram", "prefill_batch",
    "page_size", "num_pages", "max_pages_per_seq", "max_batch_size",
    "decode_block", "pipeline_depth", "prefill_buckets",
    "mixed_batching", "max_step_tokens", "mixed_buckets", "async_depth",
    "prefix_cache", "offload", "offload_copy_pages",
    "quantize", "kv_quantize",
)
# The mesh fields, recorded as the engine resolved them (EngineConfig's tp
# 0 means "every rank").
PORT_ENGINE_FIELDS = {"tp": 1, "dp": 1, "sp": 1, "ep": 1}


def model_config_dict(model_cfg: Any) -> dict[str, Any]:
    return dataclasses.asdict(model_cfg)


def engine_config_dict(cfg: Any, mesh: dict[str, int] | None = None) -> dict[str, Any]:
    """The manifest's engine block; ``mesh`` the engine's resolved mesh
    axes (one rank without it)."""
    out: dict[str, Any] = {}
    axes = {**PORT_ENGINE_FIELDS, **(mesh or {})}
    for name in ENGINE_FINGERPRINT_FIELDS:
        v = axes[name] if name in axes else getattr(cfg, name)
        out[name] = list(v) if isinstance(v, tuple) else v
    out["dtype"] = DTYPE_NAMES[cfg.dtype]
    return out


def write_snapshot(engine: Any, path: str) -> dict[str, Any] | None:
    """Write ``engine``'s restart snapshot under ``path`` (made if needed).
    Returns the manifest (None on a follower rank, which only takes part in
    the gathers). Reads only the weights, the kernel libraries and the
    configs: the engine keeps serving."""
    t0 = time.perf_counter()
    lead = engine.mesh.leader
    if lead:
        os.makedirs(os.path.join(path, WEIGHTS_DIR), exist_ok=True)
    cfg, model_cfg, model = engine.cfg, engine.model_cfg, engine.model
    state = model.state_dict()
    empty_layer = None
    leaves = []
    weights_bytes = 0
    for i, (leaf_path, key, first, count) in enumerate(jax_leaves(model_cfg, cfg.quantize)):
        if "{i}" not in key:
            keys = [key]
        elif count:
            keys = [key.format(i=first + j) for j in range(count)]
        else:
            keys = []
        # Each part gathered whole just before it is written.
        parts = (model.full_tensor(k, state[k]) for k in keys)
        fname = os.path.join(WEIGHTS_DIR, f"leaf-{i:05d}.bin")
        h = hashlib.blake2b(digest_size=16)
        nbytes = 0
        dtype = shape = None
        with open(os.path.join(path, fname), "wb") if lead else contextlib.nullcontext() as f:
            for t in parts:
                dtype, shape = t.dtype, list(t.shape)
                if not lead:
                    continue
                data = leaf_bytes(t)
                f.write(data)
                h.update(data)
                nbytes += len(data)
        if "{i}" in key:
            if not keys:
                # A stack without layers (every layer a MoE layer): JAX
                # holds its leaves with a leading 0.
                if empty_layer is None:
                    empty_layer = DecoderLayer(model_cfg, cfg.dtype, torch.device("meta"),
                                               cfg.quantize).state_dict()
                like = empty_layer[key.removeprefix("layers.{i}.")]
                dtype, shape = like.dtype, list(like.shape)
            shape = [len(keys), *shape]
        weights_bytes += nbytes
        leaves.append({
            "path": leaf_path, "file": fname, "dtype": DTYPE_NAMES[dtype],
            "shape": shape, "nbytes": nbytes, "digest": h.hexdigest(),
        })
    if not lead:
        return None

    # The built kernel libraries: the restoring engine finds them built.
    dst_cache = os.path.join(path, COMPILE_CACHE_DIR)
    os.makedirs(dst_cache, exist_ok=True)
    cache_entries = cache_bytes = 0
    for lib in cuda_build.built_libraries():
        shutil.copy2(lib, os.path.join(dst_cache, lib.name))
        cache_entries += 1
        cache_bytes += lib.stat().st_size

    kv_leaves = []
    # The cache's global leaf shapes, as JAX records them: at tp > 1 a
    # rank's pages hold K/tp of the kv heads (axis 3), the latent cache all.
    heads = 1 if engine.cache.latent else engine.mesh.shape["tp"]
    for name, leaf in engine.cache.page_leaves().items():
        top, _, part = name.partition(".")
        kp = f"['{top}']" + ({"q": "[<flat index 0>]", "scale": "[<flat index 1>]"}[part]
                             if part else "")
        shape = list(leaf.shape)
        shape[3] *= heads
        kv_leaves.append({"path": kp, "dtype": DTYPE_NAMES[leaf.dtype], "shape": shape})
    model = model_config_dict(model_cfg)
    eng_dict = engine_config_dict(cfg, engine.mesh.describe())
    dev = engine.device
    man = {
        "format": FORMAT_VERSION,
        "created_unix": time.time(),
        "fingerprint": fingerprint(model, eng_dict),
        "model": model,
        "engine": eng_dict,
        "leaves": leaves,
        "kv_plan": {
            "num_pages": cfg.num_pages, "page_size": cfg.page_size,
            "max_pages_per_seq": cfg.max_pages_per_seq, "kv_quantize": cfg.kv_quantize,
            "leaves": kv_leaves,
        },
        "compile_cache": {"entries": cache_entries, "bytes": cache_bytes},
        "torch": {
            "version": torch.__version__,
            "device_type": dev.type,
            "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": torch.cuda.device_count() if dev.type == "cuda" else 0,
            "paged_backend": cfg.paged_backend,
            "mesh": engine.mesh.describe(),
        },
    }
    write_manifest(path, man)

    dt = time.perf_counter() - t0
    obs.SNAPSHOT_OPS.inc(op="write")
    obs.SNAPSHOT_WRITE_SECONDS.observe(dt)
    obs.SNAPSHOT_BYTES.set(float(weights_bytes), part="weights")
    obs.SNAPSHOT_BYTES.set(float(cache_bytes), part="compile_cache")
    obs.flight.record(
        "snapshot_write", path=path, seconds=round(dt, 3), leaves=len(leaves),
        weights_bytes=weights_bytes, compile_cache_entries=cache_entries,
        fingerprint=man["fingerprint"],
    )
    log.info("snapshot written to %s: %d weight leaves (%.1f MiB), %d kernel "
             "libraries in %.1f s [fp=%s]", path, len(leaves), weights_bytes / 2**20,
             cache_entries, dt, man["fingerprint"])
    return man
