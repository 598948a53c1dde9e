"""The yardstick's arithmetic: the chip's published peaks and, per model
family (one module each, found by the configuration's ``family``), the
operations and bytes of the model's work worked out from the
configuration's shapes.

A family module gives, from the published config dict ``hf``:

- ``params(hf)``: {"total", "active", "body_active"} parameter counts
  (active: the weights one token passes through, the lm_head included;
  body: the layers alone);
- ``kv_token_bytes(hf)``: cache bytes one token holds over all layers, in
  bf16;
- ``attn_flops(hf, pairs)`` and ``attn_bytes(hf, q_tokens, kv_tokens)``:
  the attention kernels' operations over ``pairs`` (query token, attended
  position) pairs, and the bytes they must move: each query read and its
  output written once, and ``kv_tokens`` cached tokens read once;
- ``model_flops(hf, q_tokens, pairs)``: the useful operations of a forward
  over ``q_tokens`` tokens: two per body-active parameter a token, plus
  the attention's. The embedding and the lm_head are left out, since the
  compositions do not say which tokens were sampled.
"""

from __future__ import annotations

# NVIDIA H100 SXM, dense rates, at its 700 W limit (NVIDIA's data sheet).
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of operations over
    the bf16 peak and bytes over the HBM bandwidth."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
