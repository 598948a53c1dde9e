"""Ragged ring attention: causal self-attention with the sequence split over
the ``sp`` mesh axis (context parallelism), and its backward.

The port's counterpart of ``opsagent_tpu/parallel/ring.py``
(``_local_ring_attention``, ``make_ring_attention``). Each rank holds S/sp
query positions; the K/V blocks rotate around the ring with ``ppermute``
while each rank keeps flash-attention-style online softmax statistics in
f32 for its queries. Causality and padding are resolved by GLOBAL
position: rank i's queries occupy [i·S_l, (i+1)·S_l); at ring step s it
holds the K/V block of rank (i − s) mod sp, masked with ``k_pos <= q_pos``
and ``k_pos < lengths[b]``, so right-padded ragged rows shard as they are.
The last step does not rotate (the block would only travel home). As in
JAX, the block products are plain products (``torch.einsum``), not a
kernel: operands in the input dtype, accumulation in f32.

Layout: q ``[B, S_l, H, D]`` with this rank's tensor-parallel heads, k/v
``[B, S_l, K, D]``.

Training differentiates the ring loop as ``jax.grad`` differentiates JAX's
``fori_loop``: autograd records each step's block products and rotates the
K/V gradients back through ``ppermute_grad`` (the inverse permutation), so
the skipped last rotation, the global-position causality and the ragged
``lengths`` carry over as they are. ``ring_attention`` is the stage-local
form, over this rank's own S/sp positions (what the trainer and the
pipeline call); ``make_ring_attention`` the whole-sequence one. Without the
ring, ``gathered_attention`` all-gathers K/V over sp, as XLA does for
JAX's sequence-sharded step.
"""

from __future__ import annotations

from typing import Callable

import torch

from .collectives import gather, ppermute_grad, replicate
from .mesh import AXES, Mesh

NEG_INF = -1e30


def ring_attention(
    q: torch.Tensor,        # [B, S_l, H, D] this rank's positions
    k: torch.Tensor,        # [B, S_l, K, D]
    v: torch.Tensor,        # [B, S_l, K, D]
    lengths: torch.Tensor,  # [B] valid GLOBAL lengths (right padding beyond)
    mesh: Mesh,
    axis: str = AXES.sp,
) -> torch.Tensor:
    """JAX's ``_local_ring_attention`` on this rank's shard: [B, S_l, H, D]
    in q's dtype. Differentiable: the K/V rotation's gradient travels back
    around the ring."""
    sp, idx = mesh.shape[axis], mesh.coords[axis]
    B, S_l, H, D = q.shape
    K = k.shape[2]
    G = H // K
    dev = q.device
    qg = (q * torch.tensor(D ** -0.5, dtype=q.dtype)).reshape(B, S_l, K, G, D).float()
    iota = torch.arange(S_l, device=dev)
    q_pos = idx * S_l + iota
    lens = lengths.to(dev).long()
    perm = [(j, (j + 1) % sp) for j in range(sp)]
    m = torch.full((B, K, G, S_l, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, K, G, S_l, D), dtype=torch.float32, device=dev)
    k_blk, v_blk = k, v
    for s in range(sp):
        src = (idx - s) % sp
        k_pos = src * S_l + iota
        scores = torch.einsum("bskgd,btkd->bkgst", qg, k_blk.float())
        mask = (k_pos[None, :] <= q_pos[:, None])[None, None, None]
        valid = (k_pos[None, :] < lens[:, None])[:, None, None, None, :]
        scores = torch.where(mask & valid, scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        probs = torch.exp(scores - m_new)
        l = alpha * l + probs.sum(dim=-1, keepdim=True)
        acc = alpha * acc + torch.einsum(
            "bkgst,btkd->bkgsd", probs.to(v_blk.dtype).float(), v_blk.float())
        m = m_new
        if s < sp - 1:
            k_blk = ppermute_grad(k_blk, mesh, axis, perm)
            v_blk = ppermute_grad(v_blk, mesh, axis, perm)
    out = acc / l.clamp_min(1e-30)                        # [B, K, G, S_l, D]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S_l, H, D).to(q.dtype)


def make_ring_attention(
    mesh: Mesh, axis: str = AXES.sp,
) -> Callable[..., torch.Tensor]:
    """A drop-in for ``causal_prefill_attention`` over WHOLE sequences,
    ``ring_attn(q, k, v, lengths=None)``: this rank takes its S/sp slice of
    the positions, rings, and the outputs are all-gathered over ``axis``,
    so every rank returns [B, S, H, D]. ``lengths`` None: every row is
    full. S must divide by sp (the engine checks its buckets). For a loss
    that every rank computes alike from the whole output, the backward
    keeps this rank's slice of the output's gradient and sums the inputs'
    gradients over ``axis``, so each rank holds the whole q/k/v
    gradient."""
    sp, idx = mesh.shape[axis], mesh.coords[axis]

    def ring_attn(q, k, v, lengths=None):
        B, S = q.shape[:2]
        if S % sp:
            raise ValueError(f"sequence of {S} positions does not divide over {axis}={sp}")
        if lengths is None:
            lengths = torch.full((B,), S, dtype=torch.int32, device=q.device)
        S_l = S // sp
        part = slice(idx * S_l, (idx + 1) * S_l)
        q, k, v = (replicate(t, mesh, axis)[:, part] for t in (q, k, v))
        out = ring_attention(q, k, v, lengths, mesh, axis)
        return gather(out, mesh, axis, dim=1)

    return ring_attn


def gathered_attention(
    q: torch.Tensor,        # [B, S_l, H, D] this rank's positions
    k: torch.Tensor,        # [B, S_l, K, D]
    v: torch.Tensor,        # [B, S_l, K, D]
    mesh: Mesh,
    axis: str = AXES.sp,
) -> torch.Tensor:
    """Causal attention of this rank's S/sp queries over the whole
    sequence's K/V, all-gathered over ``axis`` (the sp step without the
    ring). Each rank's queries go on to its own part of the loss, so the
    K/V gradients are summed over the axis before each rank keeps its
    slice. Plain PyTorch, f32 softmax: [B, S_l, H, D] in q's dtype."""
    B, S_l, H, D = q.shape
    K = k.shape[2]
    k, v = (gather(t, mesh, axis, dim=1, grad="sum") for t in (k, v))
    q_pos = mesh.coords[axis] * S_l + torch.arange(S_l, device=q.device)
    k_pos = torch.arange(k.shape[1], device=q.device)
    qg = q.float().reshape(B, S_l, K, H // K, D) * D ** -0.5
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float())
    scores = scores.masked_fill(k_pos[None, :] > q_pos[:, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(B, S_l, H, D).to(q.dtype)
