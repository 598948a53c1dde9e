"""Rotary position embeddings, llama "rotate_half" convention, unscaled
(the port's counterpart of ``opsagent_tpu/ops/rope.py`` without the
llama3/YaRN frequency scaling, which later slices add)."""

from __future__ import annotations

import torch


def rope_table(
    positions: torch.Tensor, head_dim: int, theta: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """positions [..., S] int -> (cos, sin), each [..., S, head_dim // 2] f32."""
    half = head_dim // 2
    exponent = (
        torch.arange(0, half, dtype=torch.float32, device=positions.device)
        / half
    )
    inv = 1.0 / (theta ** exponent)
    angles = positions.to(torch.float32)[..., None] * inv
    return torch.cos(angles), torch.sin(angles)


def apply_rope(
    x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
) -> torch.Tensor:
    """x [B, S, H, D]; cos/sin [B, S, D//2], broadcast over heads. The
    rotation runs in f32 (bf16 * f32 promotes) and returns x's dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c, s = cos[..., None, :], sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)
