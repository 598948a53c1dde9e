"""The device mesh: one process per rank, a process group per mesh axis.

The port's counterpart of ``opsagent_tpu/parallel/mesh.py``. JAX runs one
controller over a ``jax.sharding.Mesh`` of devices and lets XLA insert the
collectives from ``PartitionSpec`` shardings. The port is SPMD: every rank
is a process that builds its own shard of the model and calls the
collectives itself (``parallel.collectives``), so the mesh here is this
rank's view of the grid:

- ``shape``: the axis sizes, in JAX's order ``pp``, ``dp``, ``sp``, ``ep``,
  ``tp`` (outer axes on the slower links: pp/dp across hosts, ep/tp
  inside one);
- ``coords``: this rank's index on each axis (the rank unravelled over
  that order, as JAX reshapes its device list);
- ``groups``: a ``ProcessGroup`` per axis larger than one, holding the
  ranks that share every other coordinate, and ``meta_group``, a gloo
  group of every rank for host metadata (the lockstep step records of
  ``serving.spmd``).

A one-rank mesh holds no process group: the single-card engine runs as it
always did. Every axis group carries a timeout (``GROUP_TIMEOUT_S``), so
that a lost rank makes the others raise instead of hang; the metadata
group waits as long as an engine may idle (``IDLE_TIMEOUT_S``).

Placement is written as in JAX, a spec per tensor: a tuple of one axis
name or ``None`` per dimension (``("tp", None)`` shards the first dimension
over ``tp``). ``shard_params`` slices full tensors to this rank's shard by
such specs. JAX's ``replicate``, ``named`` and ``spec_tree_shardings`` build
``NamedSharding`` placement objects for its partitioner; under SPMD a
replicated tensor is simply the full tensor on every rank, and there is no
sharding object to build, so they have no counterpart here.
"""

from __future__ import annotations

import gc
import os
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Any, Callable

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class MeshAxes:
    pp: str = "pp"
    dp: str = "dp"
    tp: str = "tp"
    sp: str = "sp"
    ep: str = "ep"


AXES = MeshAxes()
# The grid's order: a rank's coordinates are its index unravelled over it.
AXIS_ORDER = (AXES.pp, AXES.dp, AXES.sp, AXES.ep, AXES.tp)
# Seconds a collective may wait for a peer before it raises.
GROUP_TIMEOUT_S = 60.0
# The host-metadata group's: a follower waits for the leader's next step
# record as long as the engine idles.
IDLE_TIMEOUT_S = 24 * 3600.0


def local_rank() -> int:
    """This process's index on its host (torch's ``LOCAL_RANK``, else
    ``RANK``, else 0). Under a multi-node launch ``RANK`` is global and
    ``LOCAL_RANK`` counts from 0 on every host."""
    return int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))


def rank_device(device: str | None = None) -> str | None:
    """The device a rank serves or trains on: ``cuda:{LOCAL_RANK %
    device_count}`` for a CUDA (or unset) device in a launched job, so
    that ranks beyond a host's cards share them (on every host of a
    multi-node job, its first rank takes ``cuda:0``); ``device`` as given
    otherwise."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return device
    if device is not None and torch.device(device).type == "cpu":
        return device
    if not torch.cuda.is_available():
        return device
    return f"cuda:{local_rank() % torch.cuda.device_count()}"


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str = "nccl",
    timeout_s: float | None = None,
) -> int:
    """Join the job's default process group. Arguments default to torch's
    launch variables (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``), which ``torchrun`` sets across hosts as on one: the global
    rank and world, the device from ``LOCAL_RANK`` (``rank_device``); the
    mesh then lays pp and dp outermost, over the hosts.
    ``coordinator_address`` is ``host:port``. Returns the world
    size: 1, joining nothing, when neither arguments nor variables are
    present (a single process needs no group), as JAX's does. ``backend``
    is the caller's: ``nccl`` between cards, ``gloo`` on the CPU or for
    ranks that share one card."""
    if dist.is_initialized():
        return dist.get_world_size()
    env = os.environ
    addr = coordinator_address
    if addr is None and "MASTER_ADDR" in env:
        addr = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    n = num_processes if num_processes is not None else (
        int(env["WORLD_SIZE"]) if "WORLD_SIZE" in env else None)
    pid = process_id if process_id is not None else (
        int(env["RANK"]) if "RANK" in env else None)
    if addr is None and n is None and pid is None:
        return 1
    if addr is None or n is None or pid is None:
        raise ValueError(
            f"init_distributed needs a coordinator address, a process count and "
            f"a process id (got {addr!r}, {n!r}, {pid!r})")
    if backend == "nccl" and torch.cuda.is_available():
        torch.cuda.set_device(local_rank() % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"tcp://{addr}", world_size=n, rank=pid,
        timeout=timedelta(seconds=GROUP_TIMEOUT_S if timeout_s is None else timeout_s),
    )
    return dist.get_world_size()


def rank_job(backend: str, fn: Callable[..., int], *args: Any) -> int:
    """This process's part of a job launched under torch's launch variables
    (``init_distributed``; a single process joins no group): run
    ``fn(*args)``, then tear every process group down while the interpreter
    still runs (``close_distributed``). ``fn`` holds the job's engine and
    mesh, so they are garbage once it returns."""
    init_distributed(backend=backend)
    try:
        rc = fn(*args)
    except BaseException:
        close_distributed(wait=False)
        raise
    close_distributed()
    return rc


def close_distributed(wait: bool = True) -> None:
    """Destroy this rank's process groups and free them. With ``wait`` the
    ranks first meet at a barrier of the default group, so that none closes
    its connections while a peer still reads from them. Freed here, each
    gloo group joins its threads (``gloo_tcp_loop``, ``pt_gloo_runloop``)
    and rank 0's TCP store its listener (``pt_tcpstore_uv``); left running
    into the interpreter's exit, those threads at times aborted a rank
    ("terminate called without an active exception"). A mesh's groups
    outlive ``destroy_process_group`` while anything holds the mesh: the
    caller drops its engine first."""
    if not dist.is_initialized():
        return
    gc.collect()  # an engine's reference cycles, and with them its mesh
    if wait:
        dist.barrier()
    dist.destroy_process_group()
    gc.collect()


@dataclass
class Mesh:
    """This rank's view of the (pp, dp, sp, ep, tp) grid."""

    shape: dict[str, int]
    coords: dict[str, int]
    rank: int = 0
    # Per axis larger than one: the group of this rank's line along it,
    # and that line's global ranks in axis order.
    groups: dict[str, Any] = field(default_factory=dict)
    ranks: dict[str, list[int]] = field(default_factory=dict)
    meta_group: Any = None
    backend: str = ""

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape.values():
            n *= s
        return n

    @property
    def leader(self) -> bool:
        return self.rank == 0

    def describe(self) -> dict[str, int]:
        """The axes a replica registers (``tp``, ``sp``, ``ep``, ``dp``)."""
        return {a: self.shape[a] for a in (AXES.tp, AXES.sp, AXES.ep, AXES.dp)}

    @classmethod
    def for_rank(cls, shape: dict[str, int], rank: int) -> Mesh:
        """A mesh's shape and one rank's coordinates, with no groups: what
        ``shard_params`` needs to slice that rank's shards."""
        shape = {a: int(shape.get(a, 1)) for a in AXIS_ORDER}
        coords: dict[str, int] = {}
        rest = rank
        for a in reversed(AXIS_ORDER):
            coords[a] = rest % shape[a]
            rest //= shape[a]
        if rest:
            raise ValueError(f"rank {rank} lies outside a mesh of {cls(shape, {}).size}")
        return cls(shape, {a: coords[a] for a in AXIS_ORDER}, rank)


def _line(shape: dict[str, int], coords: dict[str, int], axis: str) -> list[int]:
    """Global ranks along ``axis`` through ``coords``, in axis order."""
    out = []
    for i in range(shape[axis]):
        c = {**coords, axis: i}
        r = 0
        for a in AXIS_ORDER:
            r = r * shape[a] + c[a]
        out.append(r)
    return out


def make_mesh(
    tp: int | None = None,
    dp: int = 1,
    sp: int = 1,
    pp: int = 1,
    ep: int = 1,
    timeout_s: float | None = None,
) -> Mesh:
    """Build this rank's (pp, dp, sp, ep, tp) mesh over the ranks of the
    default process group (one rank when none is initialized). ``tp=None``
    or 0 uses all remaining ranks. Every rank of the job must call it, in
    the same order as its other group creations: each axis group is made
    by every rank. Every rank must hold a place in the mesh."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if tp is None or tp <= 0:
        if n % (pp * dp * sp * ep) != 0:
            raise ValueError(
                f"{n} devices not divisible by pp*dp*sp*ep="
                f"{pp * dp * sp * ep}"
            )
        tp = n // (pp * dp * sp * ep)
    need = pp * dp * sp * ep * tp
    if need > n:
        raise ValueError(
            f"mesh pp={pp} dp={dp} sp={sp} ep={ep} tp={tp} needs {need} "
            f"devices, have {n}"
        )
    if need < n:
        raise ValueError(
            f"mesh pp={pp} dp={dp} sp={sp} ep={ep} tp={tp} uses {need} of {n} "
            "ranks: under SPMD every rank must hold a place in the mesh"
        )
    mesh = Mesh.for_rank({"pp": pp, "dp": dp, "sp": sp, "ep": ep, "tp": tp}, rank)
    if n == 1:
        return mesh
    mesh.backend = dist.get_backend()
    timeout = timedelta(seconds=GROUP_TIMEOUT_S if timeout_s is None else timeout_s)
    # Every rank makes every group, in one order, as new_group requires.
    for axis in AXIS_ORDER:
        if mesh.shape[axis] == 1:
            continue
        lines = sorted({tuple(_line(mesh.shape, Mesh.for_rank(mesh.shape, r).coords, axis))
                        for r in range(n)})
        for line in lines:
            group = dist.new_group(list(line), timeout=timeout)
            if rank in line:
                mesh.groups[axis] = group
                mesh.ranks[axis] = list(line)
    mesh.meta_group = dist.new_group(list(range(n)), backend="gloo",
                                     timeout=timedelta(seconds=IDLE_TIMEOUT_S))
    return mesh


def shard_slices(shape: tuple[int, ...], spec: tuple, mesh: Mesh) -> tuple[slice, ...]:
    """The slice of a full tensor of ``shape`` that this rank holds under
    ``spec`` (one axis name or None per leading dimension; missing trailing
    entries are None). Raises when a sharded dimension does not divide."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {tuple(shape)}")
    out = []
    for d, size in enumerate(shape):
        axis = spec[d] if d < len(spec) else None
        n = 1 if axis is None else mesh.shape[axis]
        if size % n:
            raise ValueError(
                f"dimension {d} of {tuple(shape)} ({size}) does not divide over "
                f"{axis}={n}")
        part = size // n
        i = 0 if axis is None else mesh.coords[axis]
        out.append(slice(i * part, (i + 1) * part))
    return tuple(out)


def shard_tensor(t: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """This rank's shard of the full tensor ``t`` under ``spec``
    (contiguous)."""
    return t[shard_slices(tuple(t.shape), spec, mesh)].contiguous()


def shard_params(params: Any, specs: Any, mesh: Mesh) -> Any:
    """Slice a (nested dict) tree of full tensors to this rank's shards by
    a matching tree of specs. A spec tree node that is a dict of specs for
    a leaf's parts (``{"q": ..., "scale": ...}``, a quantized weight) meets
    a matching dict of tensors."""
    if isinstance(params, dict):
        return {k: shard_params(v, specs[k], mesh) for k, v in params.items()}
    return shard_tensor(params, specs, mesh)
