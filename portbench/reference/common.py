"""Plain float32 pieces the families' reference forwards share: RMSNorm,
rotary embeddings (plain and YaRN, as the published configs define them),
causal attention in query blocks, the gated MLP, and the layer-by-layer
driver that turns a family's layer function into logits at chosen
positions. Imports nothing of the port."""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

from ..weights import Spec

# Queries per block of the causal attention: [heads, block, S] f32 scores.
Q_BLOCK = 1024


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope_freqs(dim: int, theta: float, scaling: dict | None) -> tuple[torch.Tensor, float]:
    """(inverse frequencies [dim // 2], cos/sin factor) of RoPE over ``dim``
    dims; with a ``{"type": "yarn", ...}`` scaling, DeepSeek-V2's YaRN
    (NTK-by-parts between beta_fast and beta_slow, mscale ratio)."""
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float64) / dim)
    if not scaling:
        return inv.float(), 1.0
    kind = scaling.get("type") or scaling.get("rope_type")
    if kind != "yarn":
        raise ValueError(f"rope scaling {kind!r} has no reference")
    factor = float(scaling["factor"])
    orig = float(scaling["original_max_position_embeddings"])

    def corr(rot: float) -> float:
        return dim * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(theta))

    low = max(math.floor(corr(scaling["beta_fast"])), 0)
    high = min(math.ceil(corr(scaling["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float64) - low) / (high - low)).clamp(0, 1)
    keep = 1.0 - ramp   # 1: the original frequency, 0: interpolated
    inv = inv / factor * (1 - keep) + inv * keep
    mscale = yarn_mscale(factor, scaling.get("mscale", 1.0)) / yarn_mscale(
        factor, scaling.get("mscale_all_dim", 1.0))
    return inv.float(), mscale


def yarn_mscale(factor: float, m: float) -> float:
    if factor <= 1 or not m:
        return 1.0
    return 0.1 * m * math.log(factor) + 1.0


def rotate(x: torch.Tensor, positions: torch.Tensor, freqs: tuple[torch.Tensor, float]) -> torch.Tensor:
    """RoPE over the last dim of x [S, heads, dim] at ``positions`` [S],
    pairing dim i with i + dim/2."""
    inv, m = freqs
    ang = positions.to(torch.float32)[:, None] * inv.to(x.device)[None, :]
    cos, sin = (torch.cos(ang) * m)[:, None, :], (torch.sin(ang) * m)[:, None, :]
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """q [S, H, D], k [S, Hk, D], v [S, Hk, Dv] (query head h reads kv head
    h // (H / Hk)) -> [S, H, Dv], causal over the S positions."""
    S, H, _ = q.shape
    g = H // k.shape[1]
    k = k.repeat_interleave(g, dim=1).transpose(0, 1)       # [H, S, D]
    v = v.repeat_interleave(g, dim=1).transpose(0, 1)       # [H, S, Dv]
    out = torch.empty(S, H, v.shape[-1], dtype=q.dtype, device=q.device)
    cols = torch.arange(S, device=q.device)
    for a in range(0, S, Q_BLOCK):
        b = min(S, a + Q_BLOCK)
        s = torch.einsum("qhd,hkd->hqk", q[a:b], k[:, :b]) * scale
        s.masked_fill_(cols[None, None, :b] > torch.arange(a, b, device=q.device)[None, :, None],
                       float("-inf"))
        out[a:b] = torch.einsum("hqk,hkd->qhd", torch.softmax(s, dim=-1), v[:, :b])
    return out


def gated_mlp(h: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor,
              mm: Callable = torch.matmul) -> torch.Tensor:
    return mm(F.silu(mm(h, wg)) * mm(h, wu), wd)


WeightsFn = Callable[[Spec], torch.Tensor]


def logits_at(
    specs: dict[str, list[Spec]], weights: WeightsFn,
    layer: Callable[[int, torch.Tensor, dict[str, torch.Tensor], torch.Tensor], torch.Tensor],
    eps: float, seqs: list[list[int]], positions: list[list[int]], device: torch.device,
    mm: Callable = torch.matmul,
) -> list[torch.Tensor]:
    """f32 logits [len(positions[i]), V] of each token sequence ``seqs[i]``
    at ``positions[i]``: the embedding, then one layer at a time over every
    sequence (``layer(i, x, W, pos)``, W the layer's f32 weights by short
    name), so that one layer's weights are held at once. ``mm`` is every
    product with a weight (the control's is of lower precision)."""
    emb = weights(specs["embed"][0]).float()
    xs = [emb[torch.tensor(s, device=device)] for s in seqs]
    del emb
    n_layers = sum(1 for key in specs if key.startswith("layers."))
    for i in range(n_layers):
        W = {sp.name.rsplit(".", 1)[-1]: weights(sp).float() for sp in specs[f"layers.{i}"]}
        for j, s in enumerate(seqs):
            xs[j] = layer(i, xs[j], W, torch.arange(len(s), device=device))
        del W
    final = {sp.name: weights(sp).float() for sp in specs["final"]}
    out = []
    for x, pos in zip(xs, positions):
        h = rms_norm(x[torch.tensor(pos, device=device)], final["final_norm"], eps)
        out.append(mm(h, final["lm_head"]))
    return out
