"""Forward collectives over one mesh axis (``parallel.mesh``).

What XLA inserts from JAX's shardings, the port's SPMD model calls itself:

- ``all_reduce_sum``: after each row-parallel product (``wo``, ``wd``, the
  shared experts' ``sd``, the routed experts' ``ed``), over ``tp``, and the
  routed experts' sum over ``ep``; the vocab-parallel embedding lookup;
- ``all_gather``: the vocab-parallel head's logits over ``tp``, ring
  attention's outputs over ``sp``;
- ``broadcast``: from an axis's first rank;
- ``ppermute``: JAX's ``jax.lax.ppermute``, each rank sending to its pair
  in ``perm`` (``batch_isend_irecv``): ring attention's K/V rotation.

Serving never differentiates, so none of them carries a gradient.

Each runs on the axis's process group, whatever its backend (``nccl``
between cards, ``gloo`` on the CPU or for ranks that share a card). gloo
takes CUDA tensors in its all-reduce, broadcast and all-gather
(``GLOO_CUDA_DIRECT``; the card's ``parallel`` phase of ``chip_smoke.py``
probes them and fails if one does not), and not in send/recv (``writev
... Bad address`` on an H100, raised or aborting the process). For the others a CUDA tensor travels through pinned
host memory, copied out and back by ``_through_host`` and counted in
``HOST_STAGED``. That is the transport the backend dictates, chosen from
the backend and the tensor's device before the call, never after a
failure; under ``nccl`` device tensors travel as they are. A one-rank axis
returns its input.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from .mesh import Mesh

# The collectives gloo runs on CUDA tensors as they are.
GLOO_CUDA_DIRECT = frozenset({"all_reduce", "broadcast", "all_gather"})
# Host-staged calls by collective (a call copies each of its tensors out
# and its results back through pinned memory).
HOST_STAGED: dict[str, int] = {
    "all_reduce": 0, "all_gather": 0, "broadcast": 0, "ppermute": 0,
}


def reset_counts() -> None:
    for name in HOST_STAGED:
        HOST_STAGED[name] = 0


def _stages(mesh: Mesh, name: str, t: torch.Tensor) -> bool:
    return t.is_cuda and mesh.backend == "gloo" and name not in GLOO_CUDA_DIRECT


def _through_host(name: str, tensors: list[torch.Tensor],
                  run: Callable[[list[torch.Tensor]], list[torch.Tensor]]
                  ) -> list[torch.Tensor]:
    """Run ``run`` over pinned host copies of CUDA ``tensors`` and bring its
    results back to their device: the transport for a gloo collective
    that takes no CUDA tensor. Counted in ``HOST_STAGED[name]``."""
    device = tensors[0].device
    host = []
    for t in tensors:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)
        host.append(h)
    out = run(host)
    HOST_STAGED[name] += 1
    return [o.to(device) for o in out]


def all_reduce_sum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over ``axis``'s ranks (a new tensor)."""
    if mesh.shape[axis] == 1:
        return x
    group = mesh.groups[axis]

    def run(ts: list[torch.Tensor]) -> list[torch.Tensor]:
        dist.all_reduce(ts[0], op=dist.ReduceOp.SUM, group=group)
        return ts

    y = x.contiguous().clone()
    if _stages(mesh, "all_reduce", y):
        return _through_host("all_reduce", [y], run)[0]
    return run([y])[0]


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    """``axis``'s ranks' ``x`` concatenated along ``dim`` in axis order."""
    n = mesh.shape[axis]
    if n == 1:
        return x
    group = mesh.groups[axis]

    def run(ts: list[torch.Tensor]) -> list[torch.Tensor]:
        parts = [torch.empty_like(ts[0]) for _ in range(n)]
        dist.all_gather(parts, ts[0], group=group)
        return parts

    x = x.contiguous()
    parts = (_through_host("all_gather", [x], run) if _stages(mesh, "all_gather", x)
             else run([x]))
    return torch.cat(parts, dim=dim)


def broadcast(x: torch.Tensor, mesh: Mesh, axis: str, src: int = 0) -> torch.Tensor:
    """``x`` of ``axis``'s rank ``src`` (an index along the axis) on every
    rank of the axis."""
    if mesh.shape[axis] == 1:
        return x
    group, root = mesh.groups[axis], mesh.ranks[axis][src]

    def run(ts: list[torch.Tensor]) -> list[torch.Tensor]:
        dist.broadcast(ts[0], src=root, group=group)
        return ts

    y = x.contiguous().clone()
    if _stages(mesh, "broadcast", y):
        return _through_host("broadcast", [y], run)[0]
    return run([y])[0]


def ppermute(x: torch.Tensor, mesh: Mesh, axis: str,
             perm: list[tuple[int, int]]) -> torch.Tensor:
    """JAX's ``ppermute``: each (src, dst) pair of axis indices sends src's
    ``x`` to dst; a rank that receives nothing gets zeros."""
    if mesh.shape[axis] == 1:
        return x if (0, 0) in perm else torch.zeros_like(x)
    me, ranks, group = mesh.coords[axis], mesh.ranks[axis], mesh.groups[axis]
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]

    def run(ts: list[torch.Tensor]) -> list[torch.Tensor]:
        out = torch.zeros_like(ts[0])
        ops = [dist.P2POp(dist.isend, ts[0], ranks[d], group=group) for d in dst]
        ops += [dist.P2POp(dist.irecv, out, ranks[s], group=group) for s in src]
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return [out]

    x = x.contiguous()
    if _stages(mesh, "ppermute", x):
        return _through_host("ppermute", [x], run)[0]
    return run([x])[0]
