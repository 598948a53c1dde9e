"""Llama-family dense decoder (GQA + RoPE + SwiGLU + RMSNorm) in PyTorch.

The port's counterpart of ``opsagent_tpu/models/llama.py`` for dense
configurations. Weights keep the JAX orientation (``x @ w`` with ``w``
``[in, out]``), so a JAX parameter tree carries across unchanged
(``models.convert``). The layer stack is a Python loop over ``nn.Module``
layers where JAX scans stacked arrays.

Entry points over the same weights:

- ``mixed_step``: ragged rows (decode rows at q_len 1 beside prefill chunks)
  over the paged cache, through the ragged paged-attention kernel;
- ``decode_step``: one token per sequence, through the decode kernel;
- ``forward_full``: all positions, plain causal attention, no cache (the
  oracle).
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.attention import causal_prefill_attention, flat_slot_indices
from ..ops.paged_attention import (
    paged_decode_attention_cuda,
    paged_ragged_attention_cuda,
)
from ..ops.rope import apply_rope, rope_table
from .config import ModelConfig


def _check_supported(cfg: ModelConfig) -> None:
    unsupported = [
        name for name, on in (
            ("moe", cfg.moe is not None),
            ("mla", cfg.mla is not None),
            ("qk_norm", cfg.qk_norm),
            ("rope_scaling", cfg.rope_scaling is not None),
            ("attn_bias", cfg.attn_bias),
            ("tie_embeddings", cfg.tie_embeddings),
        ) if on
    ]
    if unsupported:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(unsupported)} not ported yet; "
            "this port serves dense Llama configurations"
        )


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype) * w


class PagedKVCache:
    """The paged KV cache: ``k`` and ``v`` are ``[L, N, P, K, D]``, the JAX
    layout, and attention reads the contiguous per-layer view
    ``k[layer]``. Writes update the buffers in place.

    One scratch slot lies just past the end of each buffer. A write that
    JAX drops with its past-the-end index (an unassigned page, a padded
    token, an inactive decode lane) lands there instead, so the write needs
    no mask and no device-to-host sync, and the device-resident decode loop
    stays free of host pulls. Nothing reads the scratch slot."""

    def __init__(
        self, cfg: ModelConfig, num_pages: int, page_size: int,
        dtype: torch.dtype, device: torch.device,
    ):
        L, K, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim_
        self.num_pages, self.page_size = num_pages, page_size
        self.layer_slots = num_pages * page_size
        self.scratch = L * self.layer_slots
        self._k = torch.zeros(self.scratch + 1, K, D, dtype=dtype, device=device)
        self._v = torch.zeros_like(self._k)
        self.k = self._k[: self.scratch].view(L, num_pages, page_size, K, D)
        self.v = self._v[: self.scratch].view(L, num_pages, page_size, K, D)

    def write(
        self, layer: int, k_new: torch.Tensor, v_new: torch.Tensor,
        flat: torch.Tensor,
    ) -> None:
        """Write ``[B, S, K, D]`` rows at layer-local flat slots ``flat``
        (``[B * S]``, from ``flat_slot_indices`` with ``total=N``, where
        ``N * P`` marks a dropped row), in place."""
        idx = torch.where(
            flat < self.layer_slots, flat + layer * self.layer_slots,
            self.scratch,
        )
        K, D = self._k.shape[1:]
        self._k.index_copy_(0, idx, k_new.reshape(-1, K, D))
        self._v.index_copy_(0, idx, v_new.reshape(-1, K, D))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device: torch.device):
        super().__init__()
        d, f = cfg.hidden_size, cfg.intermediate_size

        def weight(*shape: int) -> nn.Parameter:
            return nn.Parameter(
                torch.empty(*shape, dtype=dtype, device=device),
                requires_grad=False,
            )

        self.attn_norm = weight(d)
        self.wq = weight(d, cfg.q_size)
        self.wk = weight(d, cfg.kv_size)
        self.wv = weight(d, cfg.kv_size)
        self.wo = weight(cfg.q_size, d)
        self.mlp_norm = weight(d)
        self.wg = weight(d, f)
        self.wu = weight(d, f)
        self.wd = weight(f, d)

    def qkv_rope(
        self, h: torch.Tensor, cfg: ModelConfig, cos: torch.Tensor,
        sin: torch.Tensor,
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        B, S, _ = h.shape
        K, D = cfg.num_kv_heads, cfg.head_dim_
        q = (h @ self.wq).view(B, S, cfg.num_heads, D)
        k = (h @ self.wk).view(B, S, K, D)
        v = (h @ self.wv).view(B, S, K, D)
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v

    def mlp(self, h: torch.Tensor) -> torch.Tensor:
        return (F.silu(h @ self.wg) * (h @ self.wu)) @ self.wd


class Llama(nn.Module):
    """Dense decoder. ``seed`` fills the weights with the fan-in-scaled
    normal init of ``opsagent_tpu``'s ``init_params`` (norms at 1), drawn
    on ``device`` from a ``torch.Generator``, so an 8B model is built on the
    card in seconds; ``seed=None`` leaves them uninitialized for
    ``load_state_dict``."""

    def __init__(
        self, cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16,
        device: str | torch.device | None = None, seed: int | None = 0,
    ):
        super().__init__()
        _check_supported(cfg)
        device = resolve_device(device)
        self.cfg, self.dtype = cfg, dtype
        d, v = cfg.hidden_size, cfg.vocab_size
        self.embed = nn.Parameter(
            torch.empty(v, d, dtype=dtype, device=device), requires_grad=False
        )
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, dtype, device) for _ in range(cfg.num_layers)
        )
        self.final_norm = nn.Parameter(
            torch.empty(d, dtype=dtype, device=device), requires_grad=False
        )
        self.lm_head = nn.Parameter(
            torch.empty(d, v, dtype=dtype, device=device), requires_grad=False
        )
        if seed is not None:
            self.init_random(seed)

    @torch.no_grad()
    def init_random(self, seed: int) -> None:
        gen = torch.Generator(device=self.embed.device).manual_seed(seed)
        for name, p in self.named_parameters():
            if name.endswith("norm"):
                p.fill_(1.0)
                continue
            # Fan-in is the contraction dim: [in, out] weights, and the
            # embedding's row width.
            fan_in = p.shape[1] if name == "embed" else p.shape[0]
            p.copy_(
                torch.randn(
                    p.shape, generator=gen, device=p.device, dtype=torch.float32
                ).mul_(fan_in ** -0.5)
            )

    def make_cache(self, num_pages: int, page_size: int) -> PagedKVCache:
        return PagedKVCache(
            self.cfg, num_pages, page_size, self.dtype, self.embed.device
        )

    def _rope(self, positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return rope_table(positions, self.cfg.head_dim_, self.cfg.rope_theta)

    def _run_stack(self, x: torch.Tensor, attn_fn) -> torch.Tensor:
        eps = self.cfg.rms_norm_eps
        for li, layer in enumerate(self.layers):
            h = rms_norm(x, layer.attn_norm, eps)
            x = x + attn_fn(h, layer, li) @ layer.wo
            x = x + layer.mlp(rms_norm(x, layer.mlp_norm, eps))
        return x

    def _lm_head(self, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, self.final_norm, self.cfg.rms_norm_eps)
        return (x @ self.lm_head).float()

    def forward_full(self, tokens: torch.Tensor) -> torch.Tensor:
        """All-positions logits [B, S, V] f32: plain causal attention over
        the fresh sequence, no cache."""
        B, S = tokens.shape
        pos = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
        cos, sin = self._rope(pos)

        def attn_fn(h, layer, li):
            q, k, v = layer.qkv_rope(h, self.cfg, cos, sin)
            return causal_prefill_attention(q, k, v).reshape(B, S, -1)

        x = self._run_stack(self.embed[tokens].to(self.dtype), attn_fn)
        return self._lm_head(x)

    def mixed_step(
        self,
        tokens: torch.Tensor,       # [B, S] int ragged rows, right-padded
        start: torch.Tensor,        # [B] int32 write offsets
        q_lens: torch.Tensor,       # [B] int32 valid rows (0 = inactive)
        cache: PagedKVCache,
        page_table: torch.Tensor,   # [B, MaxP] int32
        plain: bool = False,
    ) -> torch.Tensor:
        """One forward over decode rows (q_len 1) and prefill chunks (q_len
        up to S) together: writes each row's valid K/V at ``start`` and
        returns the logits of its last valid position [B, V] f32. Rows with
        q_len 0 write nothing; their logits are discarded by the caller.
        ``plain`` runs attention through the plain PyTorch version."""
        B, S = tokens.shape
        pos = start.long()[:, None] + torch.arange(S, device=tokens.device)[None, :]
        cos, sin = self._rope(pos)
        flat = flat_slot_indices(
            page_table, start, S, cache.page_size, cache.num_pages,
            valid_len=q_lens,
        ).reshape(-1)

        def attn_fn(h, layer, li):
            q, k, v = layer.qkv_rope(h, self.cfg, cos, sin)
            cache.write(li, k, v, flat)
            # cache.k[li] is a view: the attention reads the rows just written.
            attn = paged_ragged_attention_cuda(
                q, cache.k[li], cache.v[li], page_table, start, q_lens,
                plain=plain,
            )
            return attn.reshape(B, S, -1)

        x = self._run_stack(self.embed[tokens].to(self.dtype), attn_fn)
        last = (q_lens.long() - 1).clamp(0, S - 1)
        return self._lm_head(x[torch.arange(B, device=x.device), last])

    def decode_step(
        self,
        tokens: torch.Tensor,       # [B] int latest sampled token per row
        lengths: torch.Tensor,      # [B] int32 tokens already in cache
        cache: PagedKVCache,
        page_table: torch.Tensor,   # [B, MaxP] int32
        active: torch.Tensor,       # [B] bool; inactive rows write nothing
        plain: bool = False,
    ) -> torch.Tensor:
        """One token per sequence: writes its K/V at ``lengths`` and returns
        the next-token logits [B, V] f32."""
        B = tokens.shape[0]
        cos, sin = self._rope(lengths.long()[:, None])
        valid = active.to(torch.int32)
        flat = flat_slot_indices(
            page_table, lengths, 1, cache.page_size, cache.num_pages,
            valid_len=valid,
        ).reshape(-1)
        seen = (lengths + valid).to(torch.int32)

        def attn_fn(h, layer, li):
            q, k, v = layer.qkv_rope(h, self.cfg, cos, sin)
            cache.write(li, k, v, flat)
            # cache.k[li] is a view: the attention reads the row just written.
            attn = paged_decode_attention_cuda(
                q[:, 0], cache.k[li], cache.v[li], page_table, seen,
                plain=plain,
            )
            return attn.reshape(B, 1, -1)

        x = self._run_stack(self.embed[tokens[:, None]].to(self.dtype), attn_fn)
        return self._lm_head(x[:, 0])
