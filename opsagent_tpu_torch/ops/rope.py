"""Rotary position embeddings, llama "rotate_half" convention, with the
long-context frequency scaling of ``opsagent_tpu/ops/rope.py``: Llama-3.1's
"llama3" wavelength-banded interpolation and YaRN, whose mscale factor is
folded into the cos/sin tables. The formulas follow the HF reference
implementations, in f32 as the JAX package computes them."""

from __future__ import annotations

import math

import torch


def yarn_get_mscale(scale: float, mscale: float) -> float:
    """YaRN attention-magnitude correction (HF yarn_get_mscale)."""
    if scale <= 1.0 or mscale == 0.0:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def _scaled_freqs(
    head_dim: int, theta: float, scaling, device: torch.device,
) -> tuple[torch.Tensor, float]:
    """(inverse frequencies [head_dim // 2] f32, cos/sin magnitude factor)."""
    half = head_dim // 2
    inv = 1.0 / (
        theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half)
    )
    if scaling is None:
        return inv, 1.0
    if scaling.rope_type == "llama3":
        # Low-frequency dims fully interpolated (divided by factor),
        # high-frequency dims untouched, a smooth ramp between.
        orig = float(scaling.original_max_position)
        wavelen = 2.0 * math.pi / inv
        low_wl = orig / scaling.low_freq_factor
        high_wl = orig / scaling.high_freq_factor
        smooth = (
            (orig / wavelen - scaling.low_freq_factor)
            / (scaling.high_freq_factor - scaling.low_freq_factor)
        )
        banded = torch.where(
            wavelen > low_wl,
            inv / scaling.factor,
            torch.where(
                wavelen < high_wl,
                inv,
                (1.0 - smooth) * inv / scaling.factor + smooth * inv,
            ),
        )
        return banded, 1.0
    if scaling.rope_type == "yarn":
        # NTK-by-parts: dims rotating faster than beta_fast at the original
        # window keep their frequency, dims slower than beta_slow
        # interpolate, a linear ramp between.
        orig = float(scaling.original_max_position)

        def correction_dim(num_rot: float) -> float:
            return (
                head_dim * math.log(orig / (num_rot * 2.0 * math.pi))
            ) / (2.0 * math.log(theta))

        low = max(math.floor(correction_dim(scaling.beta_fast)), 0)
        high = min(math.ceil(correction_dim(scaling.beta_slow)), head_dim - 1)
        ramp = torch.clamp(
            (torch.arange(half, dtype=torch.float32, device=device) - low)
            / max(high - low, 1e-3),
            0.0, 1.0,
        )
        extrap = 1.0 - ramp
        yarned = inv / scaling.factor * (1.0 - extrap) + inv * extrap
        att = yarn_get_mscale(scaling.factor, scaling.mscale) / yarn_get_mscale(
            scaling.factor, scaling.mscale_all_dim
        )
        return yarned, att
    raise ValueError(f"unknown rope scaling type {scaling.rope_type!r}")


def rope_table(
    positions: torch.Tensor, head_dim: int, theta: float, scaling=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """positions [..., S] int -> (cos, sin), each [..., S, head_dim // 2]
    f32. ``scaling`` is an optional ``config.RopeScalingConfig``."""
    freqs, att = _scaled_freqs(head_dim, theta, scaling, positions.device)
    angles = positions.to(torch.float32)[..., None] * freqs
    if att == 1.0:
        return torch.cos(angles), torch.sin(angles)
    return torch.cos(angles) * att, torch.sin(angles) * att


def apply_rope(
    x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
) -> torch.Tensor:
    """x [B, S, H, D]; cos/sin [B, S, D//2], broadcast over heads. The
    rotation runs in f32 (bf16 * f32 promotes) and returns x's dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c, s = cos[..., None, :], sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)
