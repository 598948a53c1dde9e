"""Training checkpoint and resume (the port's counterpart of
``opsagent_tpu/training/checkpoint.py``).

Layout: ``<dir>/step_<N>/`` as in JAX. A one-rank model's step holds one
``state.pt``: ``{"params": model.state_dict(), "opt_state":
optimizer.state_dict()}``. A sharded model's (``Llama(mesh=...)``) holds
each rank's shards, ``rank_<r>.pt`` (``{"params": {name: shard},
"opt_state": {name: AdamW's state of that shard}}``), beside
``manifest.json``: the mesh shape, every entry's spec and the step. Files
are written with ``torch.save`` and read back with ``weights_only=True``
(the machine beside the card has no orbax). A save writes into a temporary
directory beside the target and renames it into place, so a crash mid-save
leaves the earlier steps intact and ``latest_step`` never sees a
half-written one, as orbax's rename does.

A restore reshards on read, as orbax does, onto any mesh, one rank
included: for each entry this rank holds, the regions of the saved shards
(``parallel.mesh.shard_slices`` over the saved mesh) that overlap its
slice are copied from the memory-mapped rank files into place, so a rank
never holds more than its own share. JAX's orbax checkpoints are not
read.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import tempfile

import torch
import torch.distributed as dist

from ..models.llama import _full_shape, state_specs
from ..parallel.mesh import Mesh, shard_slices

STATE_FILE = "state.pt"
MANIFEST = "manifest.json"


def _step_dir(dirpath: str, step: int) -> str:
    return os.path.join(os.path.abspath(dirpath), f"step_{step}")


def latest_step(dirpath: str) -> int | None:
    """Highest completed checkpoint step in ``dirpath``, or None."""
    if not os.path.isdir(dirpath):
        return None
    steps = [
        int(m.group(1))
        for name in os.listdir(dirpath)
        if (m := re.fullmatch(r"step_(\d+)", name))
    ]
    return max(steps) if steps else None


def _barrier(mesh: Mesh) -> None:
    """Every rank of the job waits here (the default group's timeout)."""
    if mesh.size > 1:
        dist.barrier()


def _named_opt_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> dict:
    names = {id(p): n for n, p in model.named_parameters()}
    return {names[id(p)]: dict(st) for p, st in optimizer.state.items()}


def _save_sharded(path: str, step: int, model, optimizer) -> str:
    """Each rank writes its shards into one temporary directory; the
    leader adds the manifest and renames it into place."""
    mesh = model.mesh
    tmp = os.path.join(os.path.dirname(path), f".step_{step}.sharded")
    if mesh.leader:
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
    _barrier(mesh)
    try:
        torch.save({"params": model.state_dict(),
                    "opt_state": _named_opt_state(model, optimizer)},
                   os.path.join(tmp, f"rank_{mesh.rank}.pt"))
        _barrier(mesh)
        if mesh.leader:
            specs = state_specs(model.cfg, model.quantize)
            with open(os.path.join(tmp, MANIFEST), "w") as f:
                json.dump({"step": step, "mesh": mesh.shape,
                           "specs": {k: list(v) for k, v in specs.items()}}, f)
            if os.path.isdir(path):
                shutil.rmtree(path)
            os.replace(tmp, path)
    except BaseException:
        if mesh.leader:
            shutil.rmtree(tmp, ignore_errors=True)
        raise
    _barrier(mesh)
    return path


def save_train_state(
    dirpath: str, step: int, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
) -> str:
    """Write the parameters and the optimizer state for ``step``; returns
    the step's path. An earlier save of the same step is replaced. A
    sharded model's ranks all call it: each writes its own shards."""
    path = _step_dir(dirpath, step)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if getattr(model, "mesh", None) is not None:
        return _save_sharded(path, step, model, optimizer)
    tmp = tempfile.mkdtemp(prefix=f".step_{step}.", dir=os.path.dirname(path))
    try:
        torch.save(
            {"params": model.state_dict(), "opt_state": optimizer.state_dict()},
            os.path.join(tmp, STATE_FILE),
        )
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return path


def _fill(dst: torch.Tensor, key: str, spec: tuple, mesh: Mesh | None,
          saved: list[tuple[Mesh, torch.Tensor]], saved_spec: tuple) -> None:
    """Copy into ``dst``, this rank's slice of the entry ``key`` under
    ``spec`` and ``mesh``, the region of each saved shard that overlaps it
    (``saved``: (the saving rank's place, its mmapped shard)). A region
    two saved ranks hold is read once; every element of ``dst`` must be
    covered."""
    full = _full_shape(saved[0][1].shape, saved_spec, saved[0][0])
    if _full_shape(dst.shape, spec, mesh) != full:
        raise ValueError(f"{key}: saved as {full}, the model's is "
                         f"{_full_shape(dst.shape, spec, mesh)}")
    mine = (shard_slices(full, spec, mesh) if mesh is not None
            else tuple(slice(0, n) for n in full))
    seen, covered = set(), 0
    for where, shard in saved:
        theirs = shard_slices(full, saved_spec, where)
        span = tuple((s.start, s.stop) for s in theirs)
        lo = [max(a.start, b.start) for a, b in zip(mine, theirs)]
        hi = [min(a.stop, b.stop) for a, b in zip(mine, theirs)]
        if span in seen or any(h <= l for l, h in zip(lo, hi)):
            continue
        seen.add(span)
        dst[tuple(slice(l - m.start, h - m.start) for l, h, m in zip(lo, hi, mine))].copy_(
            shard[tuple(slice(l - t.start, h - t.start) for l, h, t in zip(lo, hi, theirs))])
        covered += math.prod(h - l for l, h in zip(lo, hi))
    if covered != dst.numel():
        raise ValueError(f"{key}: the saved shards cover {covered} of this rank's "
                         f"{dst.numel()} elements")


def _restore_sharded(path: str, model, optimizer) -> None:
    """Reshard on read: each entry this rank holds is copied, region by
    region, from the saved shards that overlap its slice (the rank files
    are memory-mapped, so nothing else of them is read), straight into the
    parameter and into a buffer for each AdamW moment."""
    with open(os.path.join(path, MANIFEST)) as f:
        man = json.load(f)
    saved_specs = {k: tuple(v) for k, v in man["specs"].items()}
    n = math.prod(man["mesh"].values())
    parts = [(Mesh.for_rank(man["mesh"], r),
              torch.load(os.path.join(path, f"rank_{r}.pt"), map_location="cpu",
                         weights_only=True, mmap=True)) for r in range(n)]
    mesh = getattr(model, "mesh", None)
    specs = state_specs(model.cfg, model.quantize)

    def saved(key: str, field: str | None) -> list[tuple[Mesh, torch.Tensor]]:
        out = []
        for where, part in parts:
            if field is None and key in part["params"]:
                out.append((where, part["params"][key]))
            elif field is not None and key in part["opt_state"]:
                out.append((where, part["opt_state"][key][field]))
        if not out:
            raise ValueError(f"{path} holds no {key}{'' if field is None else ' ' + field}")
        return out

    with torch.no_grad():
        for key, t in model.state_dict().items():
            _fill(t, key, specs[key], mesh, saved(key, None), saved_specs[key])
    for name, p in model.named_parameters():
        fields = next((part["opt_state"][name] for _, part in parts
                       if name in part["opt_state"]), None)
        if fields is None:
            continue
        state = {}
        for field, t in fields.items():
            if t.dim() == 0:
                state[field] = t.clone()
            else:
                state[field] = torch.empty_like(p)
                _fill(state[field], name, specs[name], mesh, saved(name, field),
                      saved_specs[name])
        optimizer.state[p] = state


def restore_train_state(
    dirpath: str, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
    step: int | None = None,
) -> tuple[torch.nn.Module, torch.optim.Optimizer, int]:
    """Load ``step`` (default: the latest) into ``model`` and ``optimizer``,
    made as a training run makes them (``init_train_state``), in place;
    returns (model, optimizer, step). Tensors load onto the devices the
    model's parameters are on. A step saved at a mesh restores onto any
    mesh, one rank included: each rank takes its slices of the saved
    entries; a one-rank step restores onto a one-rank model."""
    if step is None:
        step = latest_step(dirpath)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {dirpath}")
    path = _step_dir(dirpath, step)
    mesh = getattr(model, "mesh", None)
    device = next(model.parameters()).device
    if not os.path.exists(os.path.join(path, MANIFEST)):
        if mesh is not None:
            raise ValueError(f"{path} holds one rank's state; a sharded model restores "
                             "a sharded step")
        state = torch.load(os.path.join(path, STATE_FILE),
                           map_location=device, weights_only=True)
        with torch.no_grad():
            model.load_state_dict(state["params"])
        optimizer.load_state_dict(state["opt_state"])
        return model, optimizer, step
    _restore_sharded(path, model, optimizer)
    return model, optimizer, step
