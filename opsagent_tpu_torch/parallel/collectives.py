"""Collectives over one mesh axis (``parallel.mesh``), and their
differentiable forms for training.

What XLA inserts from JAX's shardings, the port's SPMD model calls itself:

- ``all_reduce_sum``: after each row-parallel product (``wo``, ``wd``, the
  shared experts' ``sd``, the routed experts' ``ed``), over ``tp``, and the
  routed experts' sum over ``ep``; the vocab-parallel embedding lookup;
- ``all_gather``: the vocab-parallel head's logits over ``tp``, ring
  attention's outputs over ``sp``;
- ``broadcast``: from an axis's first rank; ``broadcast_from_leader``:
  from global rank 0 to every rank of the job (the host KV tier's page
  restores, whose data only the leader holds);
- ``ppermute``: JAX's ``jax.lax.ppermute``, each rank sending to its pair
  in ``perm`` (``batch_isend_irecv``): ring attention's K/V rotation;
- ``send`` / ``recv``: one tensor from one rank of an axis to another
  (``dist.send`` / ``dist.recv``): the pipeline's activations and their
  gradients between neighbouring stages.

These carry no gradient; serving never differentiates. Training calls
their ``torch.autograd.Function`` forms (``reduce_sum``, ``replicate``,
``gather``, ``ppermute_grad``), which a caller takes only when the tensor
requires a gradient, so that a step with gradients off runs exactly the
functions above. Their backward follows Megatron's conjugate pair, for a
loss that every rank of a tp (or ep) line computes alike from replicated
tensors:

- ``reduce_sum`` (a row-parallel partial sum, the vocab-parallel
  embedding, the ep sum of expert terms): all-reduce forward, the gradient
  passed through;
- ``replicate`` (a replicated tensor entering a sharded product, a
  replicated weight used on this rank's heads): identity forward, the
  gradient all-reduced over the axes;
- ``gather`` (the head's vocab columns, a ring output every rank goes on
  with whole): all-gather forward; backward keeps this rank's slice, since
  each rank holds the whole loss's gradient already. ``grad="sum"``
  all-reduces the gradient first, for a gather whose ranks each go on with
  a part of the loss (the K/V of the sequence-sharded attention);
- ``ppermute_grad``: ``ppermute`` forward, and ``ppermute`` by the inverse
  permutation backward, host-staged under gloo as the forward is.

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
    "all_reduce": 0, "all_gather": 0, "broadcast": 0, "ppermute": 0, "send": 0, "recv": 0,
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


def broadcast_from_leader(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` of global rank 0 on every rank of the job, over the default
    group, in place: every rank passes a tensor of the same shape and dtype
    (the others' contents are overwritten)."""
    if mesh.size == 1:
        return x

    def run(ts: list[torch.Tensor]) -> list[torch.Tensor]:
        dist.broadcast(ts[0], src=0)
        return ts

    if not x.is_contiguous():
        raise ValueError("broadcast_from_leader writes in place: pass a contiguous tensor")
    if _stages(mesh, "broadcast", x):
        return x.copy_(_through_host("broadcast", [x], run)[0])
    return run([x])[0]


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


def send(x: torch.Tensor, mesh: Mesh, axis: str, dst: int) -> None:
    """Send ``x`` to ``axis``'s rank ``dst`` (an index along the axis);
    returns once it is received or the group times out."""
    group, peer = mesh.groups[axis], mesh.ranks[axis][dst]

    def run(ts: list[torch.Tensor]) -> list[torch.Tensor]:
        dist.send(ts[0], peer, group=group)
        return []

    x = x.contiguous()
    if _stages(mesh, "send", x):
        _through_host("send", [x], run)
    else:
        run([x])


def recv(like: torch.Tensor, mesh: Mesh, axis: str, src: int) -> torch.Tensor:
    """A tensor shaped as ``like`` (its dtype and device) from ``axis``'s
    rank ``src``."""
    group, peer = mesh.groups[axis], mesh.ranks[axis][src]

    def run(ts: list[torch.Tensor]) -> list[torch.Tensor]:
        dist.recv(ts[0], peer, group=group)
        return ts

    buf = torch.empty_like(like, memory_format=torch.contiguous_format)
    if _stages(mesh, "recv", buf):
        host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
        run([host])
        HOST_STAGED["recv"] += 1
        return buf.copy_(host)
    return run([buf])[0]


# -- the differentiable forms (training) ---------------------------------------
def _axes(mesh: Mesh, axes: str | tuple[str, ...]) -> tuple[str, ...]:
    """The axes of ``axes`` larger than one rank."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return tuple(a for a in axes if mesh.shape[a] > 1)


def _sum_over(x: torch.Tensor, mesh: Mesh, axes: tuple[str, ...]) -> torch.Tensor:
    for a in axes:
        x = all_reduce_sum(x, mesh, a)
    return x


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _sum_over(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_over(g, ctx.mesh, ctx.axes), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, grad_sum):
        ctx.mesh, ctx.axis, ctx.dim, ctx.grad_sum = mesh, axis, dim, grad_sum
        ctx.size = x.shape[dim]
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad_sum:
            g = all_reduce_sum(g, ctx.mesh, ctx.axis)
        i = ctx.mesh.coords[ctx.axis]
        return g.narrow(ctx.dim, i * ctx.size, ctx.size), None, None, None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.mesh, ctx.axis, ctx.perm = mesh, axis, perm
        return ppermute(x, mesh, axis, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = [(d, s) for s, d in ctx.perm]
        return ppermute(g, ctx.mesh, ctx.axis, inverse), None, None, None


def _differentiates(x: torch.Tensor) -> bool:
    return x.requires_grad and torch.is_grad_enabled()


def reduce_sum(x: torch.Tensor, mesh: Mesh | None,
               axes: str | tuple[str, ...]) -> torch.Tensor:
    """The sum of ``x`` over ``axes`` (in order); the gradient passes
    through. ``all_reduce_sum`` when ``x`` needs no gradient."""
    axes = () if mesh is None else _axes(mesh, axes)
    if not axes:
        return x
    if _differentiates(x):
        return _ReduceSum.apply(x, mesh, axes)
    return _sum_over(x, mesh, axes)


def replicate(x: torch.Tensor, mesh: Mesh | None,
              axes: str | tuple[str, ...]) -> torch.Tensor:
    """``x`` itself; its gradient is summed over ``axes``."""
    axes = () if mesh is None else _axes(mesh, axes)
    if not axes or not _differentiates(x):
        return x
    return _Replicate.apply(x, mesh, axes)


def gather(x: torch.Tensor, mesh: Mesh, axis: str, dim: int,
           grad: str = "slice") -> torch.Tensor:
    """``all_gather`` along ``dim``; its backward keeps this rank's slice of
    the gradient (``grad="slice"``) or of the gradient summed over the
    axis (``grad="sum"``)."""
    if mesh.shape[axis] == 1:
        return x
    if not _differentiates(x):
        return all_gather(x, mesh, axis, dim)
    return _Gather.apply(x, mesh, axis, dim % x.dim(), grad == "sum")


def ppermute_grad(x: torch.Tensor, mesh: Mesh, axis: str,
                  perm: list[tuple[int, int]]) -> torch.Tensor:
    """``ppermute``, differentiable: the gradient travels back by the
    inverse permutation."""
    if mesh.shape[axis] == 1 or not _differentiates(x):
        return ppermute(x, mesh, axis, perm)
    return _PPermute.apply(x, mesh, axis, perm)
