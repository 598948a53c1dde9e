"""Snapshot restore: memory-mapped weights into the model, pre-seeded kernel
libraries (the port's counterpart of
``opsagent_tpu/serving/snapshot/restore.py``).

Each weight leaf file is memory-mapped copy-on-write and sliced into its
layers as views, so the only copy is the load into the model on the
device. The leaf order is not read from the snapshot: it is derived from
the manifest's configs (``models.convert.spec_leaf_paths``) and held
against the manifest's recorded paths before anything reaches the device.
The snapshot may be the port's or the JAX package's, written at one rank
or at a mesh: its leaves are whole either way. At a mesh every rank of the
job restores, each keeping its slice of every leaf
(``Llama.load_full_state_dict``).

Refused up front, with the offending field named: a fingerprint that does
not match the configs, a mesh whose size is not the job's world size (as
the JAX package refuses a device count unlike its own), a card count
other than this host's, a leaf order that drifted, and a leaf file of the
wrong size.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import shutil
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ... import obs
from ...device import resolve_device
from ...models.config import MLAConfig, MoEConfig, ModelConfig, RopeScalingConfig
from ...models.convert import DTYPE_NAMES, jax_leaves, spec_leaf_paths
from ...ops import cuda_build
from ..engine import Engine, EngineConfig
from .manifest import COMPILE_CACHE_DIR, SnapshotError, fingerprint, read_manifest

log = logging.getLogger("opsagent_tpu_torch.snapshot")

_DTYPES = {v: k for k, v in DTYPE_NAMES.items()}
# How a leaf file's bytes are mapped (numpy has no bfloat16 here: its
# 16-bit words are mapped and viewed as bfloat16 by torch).
_MAP_DTYPES = {"bfloat16": np.int16, "float16": np.float16, "float32": np.float32,
               "int8": np.int8, "int32": np.int32}
_SHARD_AXES = ("tp", "dp", "sp", "ep")


def _refuse(message: str) -> SnapshotError:
    obs.SNAPSHOT_OPS.inc(op="refused")
    return SnapshotError(message)


def model_config_from_manifest(man: dict[str, Any]) -> ModelConfig:
    m = dict(man["model"])
    moe, mla, rs = m.pop("moe", None), m.pop("mla", None), m.pop("rope_scaling", None)
    return ModelConfig(
        **m,
        moe=MoEConfig(**moe) if moe else None,
        mla=MLAConfig(**mla) if mla else None,
        rope_scaling=RopeScalingConfig(**rs) if rs else None,
    )


def engine_config_from_manifest(man: dict[str, Any], device: str | None = None) -> EngineConfig:
    """The port's EngineConfig from the manifest's engine block: its own
    fields (the JAX-only ones are checked, not carried), the dtype, and
    the paged-attention kernels a port snapshot names."""
    e = man["engine"]
    names = {f.name for f in dataclasses.fields(EngineConfig)}
    kw = {k: v for k, v in e.items() if k in names and k != "dtype"}
    kw["dtype"] = _DTYPES[e["dtype"]]
    kw["mixed_buckets"] = tuple(kw["mixed_buckets"])
    kw["prefill_buckets"] = tuple(kw["prefill_buckets"])
    backend = man.get("torch", {}).get("paged_backend")
    if backend:
        kw["paged_backend"] = backend
    return EngineConfig(**kw, device=device)


def preseed_kernels(path: str) -> int:
    """Copy the snapshot's kernel libraries into the kernel build directory
    (never over one already there). Returns libraries copied. A JAX
    snapshot's XLA cache entries are not libraries and are left."""
    src = os.path.join(path, COMPILE_CACHE_DIR)
    if not os.path.isdir(src):
        return 0
    copied = 0
    for name in sorted(os.listdir(src)):
        if not (name.startswith("lib") and name.endswith(".so")):
            continue
        dst = cuda_build.BUILD_DIR / name
        if dst.exists():
            continue
        cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = dst.with_suffix(f".{os.getpid()}.tmp")
        shutil.copy2(os.path.join(src, name), tmp)
        os.replace(tmp, dst)
        copied += 1
    return copied


def _map_leaf(path: str, rec: dict[str, Any]) -> torch.Tensor:
    fpath = os.path.join(path, rec["file"])
    if not os.path.exists(fpath):
        raise _refuse(f"missing weight leaf file {rec['file']}")
    size = os.path.getsize(fpath)
    if size != rec["nbytes"]:
        raise _refuse(f"{rec['file']}: {size} bytes on disk, manifest says "
                      f"{rec['nbytes']} (truncated or corrupt snapshot)")
    dtype = _DTYPES[rec["dtype"]]
    if size == 0:
        return torch.empty(rec["shape"], dtype=dtype)
    mm = np.memmap(fpath, dtype=_MAP_DTYPES[rec["dtype"]], mode="c",
                   shape=tuple(rec["shape"]))
    return torch.from_numpy(mm).view(dtype)


def restore_state(man: dict[str, Any], path: str, model_cfg: ModelConfig,
                  quantize: str) -> dict[str, torch.Tensor]:
    """The model's state dict over memory-mapped leaf files: each stacked
    leaf sliced into its layers as views."""
    state: dict[str, torch.Tensor] = {}
    for rec, (_, key, first, count) in zip(man["leaves"], jax_leaves(model_cfg, quantize)):
        t = _map_leaf(path, rec)
        if "{i}" not in key:
            state[key] = t
        else:
            for j in range(count):
                state[key.format(i=first + j)] = t[j]
    return state


def snapshot_mesh(man: dict[str, Any]) -> dict[str, int]:
    """The mesh axes a snapshot was written at: its engine block's, the
    largest of it and the ``jax`` or ``torch`` block's resolved mesh (an
    engine block's tp 0 means "every device")."""
    axes: dict[str, int] = {}
    for block in (man["engine"], man.get("jax", {}).get("mesh", {}),
                  man.get("torch", {}).get("mesh", {})):
        for a, v in block.items():
            if a in _SHARD_AXES:
                axes[a] = max(axes.get(a, 1), int(v or 1))
    return axes


def restore_engine(path: str, warmup: bool = False, tokenizer: Any = None,
                   device: str | None = None, host_pool_bytes: int = 0,
                   eager: bool = False) -> Engine:
    """``Engine.from_snapshot``'s body."""
    t0 = time.perf_counter()
    man = read_manifest(path)
    fp = fingerprint(man["model"], man["engine"])
    if fp != man["fingerprint"]:
        raise _refuse(
            f"refusing restore from {path}: config fingerprint {fp} != manifest "
            f"fingerprint {man['fingerprint']} (the manifest's configs were "
            "edited after the snapshot was written, or the file is corrupt)")
    axes = snapshot_mesh(man)
    need = int(np.prod(list(axes.values()) or [1]))
    world = dist.get_world_size() if dist.is_initialized() else 1
    if need != world:
        raise _refuse(
            f"refusing restore from {path}: snapshot was written at the mesh "
            f"{ {a: v for a, v in axes.items() if v > 1} or 'one rank'} of {need} "
            f"rank(s), this job has a world size of {world}; restore it in a job of "
            f"{need} rank(s)")
    dev = resolve_device(device)
    if "torch" in man:
        want = int(man["torch"]["count"])
        have = torch.cuda.device_count() if dev.type == "cuda" else 0
        if want != have:
            raise _refuse(f"refusing restore from {path}: snapshot was written "
                          f"with {want} cards visible, this host has {have}")
    model_cfg = model_config_from_manifest(man)
    cfg = dataclasses.replace(engine_config_from_manifest(man, device),
                              host_pool_bytes=host_pool_bytes, cuda_graphs=not eager)
    expect = [rec["path"] for rec in man["leaves"]]
    got = spec_leaf_paths(model_cfg, cfg.quantize)
    if got != expect:
        drift = next((i for i, (a, b) in enumerate(zip(expect, got)) if a != b),
                     min(len(expect), len(got)))
        raise _refuse(
            f"refusing restore from {path}: weight leaf order drifted at index "
            f"{drift} (snapshot: {expect[drift] if drift < len(expect) else '<end>'}, "
            f"this build: {got[drift] if drift < len(got) else '<end>'})")
    state = restore_state(man, path, model_cfg, cfg.quantize)
    preseeded = preseed_kernels(path) if dev.type == "cuda" else 0

    eng = Engine(cfg, model_cfg=model_cfg, tokenizer=tokenizer, state=state)
    del state
    eng.init_stats.update(
        restore_source=os.path.abspath(path),
        snapshot_fingerprint=man["fingerprint"],
        kernel_cache_preseeded=preseeded,
    )
    if warmup and eng.mesh.leader:
        # A follower warms up through the leader's op (``Engine.follow``).
        eng.warmup()
    dt = time.perf_counter() - t0
    obs.SNAPSHOT_OPS.inc(op="restore")
    obs.SNAPSHOT_RESTORE_SECONDS.observe(dt)
    obs.flight.record("snapshot_restore", path=path, seconds=round(dt, 3),
                      leaves=len(man["leaves"]), compile_cache_preseeded=preseeded,
                      fingerprint=man["fingerprint"])
    log.info("engine restored from %s in %.1f s (%d leaves mapped, %d kernel "
             "libraries pre-seeded) [fp=%s]", path, dt, len(man["leaves"]),
             preseeded, man["fingerprint"])
    return eng
