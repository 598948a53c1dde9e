"""Ragged ring attention: causal self-attention with the sequence split over
the ``sp`` mesh axis (context parallelism), forward only.

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
"""

from __future__ import annotations

from typing import Callable

import torch

from .collectives import all_gather, ppermute
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
    in q's dtype."""
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
            k_blk = ppermute(k_blk, mesh, axis, perm)
            v_blk = ppermute(v_blk, mesh, axis, perm)
    out = acc / l.clamp_min(1e-30)                        # [B, K, G, S_l, D]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S_l, H, D).to(q.dtype)


def make_ring_attention(
    mesh: Mesh, axis: str = AXES.sp,
) -> Callable[..., torch.Tensor]:
    """A drop-in for ``causal_prefill_attention`` over WHOLE sequences,
    ``ring_attn(q, k, v, lengths=None)``: this rank takes its S/sp slice of
    the positions, rings, and the outputs are all-gathered over ``axis``,
    so every rank returns [B, S, H, D]. ``lengths`` None: every row is
    full. S must divide by sp (the engine checks its buckets)."""
    sp, idx = mesh.shape[axis], mesh.coords[axis]

    def ring_attn(q, k, v, lengths=None):
        B, S = q.shape[:2]
        if S % sp:
            raise ValueError(f"sequence of {S} positions does not divide over {axis}={sp}")
        if lengths is None:
            lengths = torch.full((B,), S, dtype=torch.int32, device=q.device)
        S_l = S // sp
        part = slice(idx * S_l, (idx + 1) * S_l)
        out = ring_attention(q[:, part], k[:, part], v[:, part], lengths, mesh, axis)
        return all_gather(out, mesh, axis, dim=1)

    return ring_attn
