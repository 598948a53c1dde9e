"""Token sampling: greedy, temperature, top-k, top-p over one batch, in one
pass with no host sync (the port's counterpart of
``opsagent_tpu/serving/sampler.py``).

Temperature 0 means argmax, the agent loop's default. Randomness comes from
an explicit ``torch.Generator``; it draws other bits than JAX's keys, so the
two agree exactly only on the greedy path and in distribution elsewhere.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

NEG_INF = -1e30

# Candidate-set size for top-k / top-p: truncated sampling works on the top
# MAX_CANDIDATES logits; plain temperature sampling is exact over the full
# vocab (Gumbel-argmax).
MAX_CANDIDATES = 64


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0
    top_k: int = 0          # 0 = disabled
    top_p: float = 1.0      # 1.0 = disabled
    max_tokens: int = 2048
    stop: tuple[str, ...] = ()
    # OpenAI logprobs: False = off; True returns each sampled token's
    # logprob, with top_logprobs (0..20) alternatives per position.
    logprobs: bool = False
    top_logprobs: int = 0
    # OpenAI logit_bias ({token_id: -100..100}, stored as pairs for
    # hashability) and repetition penalties (-2..2): together one additive
    # per-token adjustment of the logits before sampling.
    logit_bias: tuple[tuple[int, float], ...] = ()
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    # Tokens generated before an engine restart: penalty counting starts
    # from them (the JAX package's restart recovery fills it; nothing in
    # the port does yet).
    penalty_history: tuple[int, ...] = ()


def _gumbel(shape: tuple[int, ...], generator: torch.Generator, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp_(min=tiny)))


def sample(
    logits: torch.Tensor,           # [B, V] float32
    generator: torch.Generator,
    temperature: torch.Tensor,      # [B] float32
    top_k: torch.Tensor,            # [B] int (0 = off)
    top_p: torch.Tensor,            # [B] float32 (1.0 = off)
    allowed_mask: torch.Tensor | None = None,  # [B, V] bool; False = forbidden
) -> torch.Tensor:
    """One token per row [B] int64:

    - temperature <= 0: argmax;
    - temperature > 0 without top-k/top-p: exact full-vocab categorical
      via Gumbel-argmax;
    - top_k > 0 and/or top_p < 1: truncated sampling over the descending
      top-``MAX_CANDIDATES`` candidates (top_k clamped to it).

    ``allowed_mask`` (constrained decoding) sets forbidden logits to
    ``NEG_INF`` before any of them."""
    B, V = logits.shape
    dev = logits.device
    if allowed_mask is not None:
        logits = torch.where(allowed_mask, logits, NEG_INF)
    t = temperature.clamp_min(1e-6)[:, None]
    greedy = logits.argmax(dim=-1)
    noisy = (logits / t + _gumbel((B, V), generator, dev)).argmax(dim=-1)

    C = min(MAX_CANDIDATES, V)
    vals, idx = torch.topk(logits, C, dim=-1)            # descending
    kk = torch.where(top_k > 0, top_k.clamp(max=C), C)[:, None]
    pos = torch.arange(C, device=dev)[None, :]
    scaled = torch.where(pos < kk, vals, NEG_INF) / t
    probs = torch.softmax(scaled, dim=-1)
    keep = probs.cumsum(dim=-1) - probs < top_p[:, None]  # always keeps one
    scaled = torch.where(keep, scaled, NEG_INF)
    choice = (scaled + _gumbel((B, C), generator, dev)).argmax(dim=-1)
    truncated = idx.gather(1, choice[:, None])[:, 0]

    wants_truncation = (top_k > 0) | (top_p < 1.0)
    sampled = torch.where(wants_truncation, truncated, noisy)
    return torch.where(temperature <= 0.0, greedy, sampled)
