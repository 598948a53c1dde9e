"""Llama-family dense decoder (GQA + RoPE + SwiGLU + RMSNorm) in PyTorch.

The port's counterpart of ``opsagent_tpu/models/llama.py`` for dense
configurations: Llama and Mistral, Qwen2's q/k/v biases, Qwen3's per-head
q/k RMSNorm, tied embeddings and llama3/YaRN rope scaling. Weights keep the
JAX orientation (``x @ w`` with ``w`` ``[in, out]``), so a JAX parameter
tree carries across unchanged (``models.convert``) and an HF checkpoint
loads with its matrices transposed (``models.loader``). The layer stack is
a Python loop over ``nn.Module`` layers where JAX scans stacked arrays.

Entry points over the same weights:

- ``mixed_step``: ragged rows (decode rows at q_len 1 beside prefill chunks)
  over the paged cache, through the ragged paged-attention kernel of the
  chosen backend ("dma" or "grid", ``ops.paged_attention.PAGED_BACKENDS``);
- ``decode_step``: one token per sequence, through that backend's decode
  kernel;
- ``forward_full``: all positions, plain causal attention, no cache (the
  oracle).

With ``quantize="int8"`` or ``"int4"`` every projection and the lm_head are
``models.quant`` weights, and ``_mm`` sends them through the quantized
matmul kernel; the cache made with ``kv_quantize="int8"`` holds int8 pages
with per-(token, kv head) scales, which the attention kernels read.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.attention import (
    QuantizedPages,
    causal_prefill_attention,
    flat_slot_indices,
    quantize_kv_rows,
)
from ..ops.paged_attention import PAGED_BACKENDS
from ..ops.quant_matmul import quant_matmul_cuda
from ..ops.rope import apply_rope, rope_table, yarn_get_mscale
from .config import ModelConfig
from .quant import QuantizedBase, QuantizedLinear, QuantizedLinear4, pack_int4

QUANTIZE_MODES = ("", "int8", "int4")
KV_QUANTIZE_MODES = ("", "int8")


def _check_supported(cfg: ModelConfig) -> None:
    unsupported = [
        name for name, on in (
            ("moe", cfg.moe is not None),
            ("mla", cfg.mla is not None),
        ) if on
    ]
    if unsupported:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(unsupported)} not ported yet "
            "(ROADMAP queue 1 item 9); this port serves dense configurations"
        )


def _yarn_q_scale(cfg: ModelConfig) -> float:
    """YaRN's softmax-scale correction (HF: softmax_scale *= mscale^2),
    folded into q so the attention's D^-1/2 stays as it is; 1.0 unless
    YaRN with ``mscale_all_dim`` applies."""
    rs = cfg.rope_scaling
    if rs is None or rs.rope_type != "yarn" or not rs.mscale_all_dim:
        return 1.0
    ms = yarn_get_mscale(rs.factor, rs.mscale_all_dim)
    return ms * ms


def _mm(x: torch.Tensor, w, plain: bool = False) -> torch.Tensor:
    """Matmul against a plain weight or a quantized one (``models.quant``):
    a quantized weight goes through ``quant_matmul_cuda`` over x flattened
    to [T, In] (its plain version on the CPU or with ``plain``)."""
    if isinstance(w, QuantizedBase):
        y = quant_matmul_cuda(x.reshape(-1, x.shape[-1]), w, plain=plain)
        return y.reshape(*x.shape[:-1], y.shape[-1])
    return x @ w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype) * w


class PagedKVCache:
    """The paged KV cache: ``k`` and ``v`` are ``[L, N, P, K, D]``, the JAX
    layout, and attention reads the contiguous per-layer view
    ``k[layer]``. Writes update the buffers in place. With
    ``kv_quantize="int8"``, ``k`` and ``v`` are ``QuantizedPages``: int8
    pages and f32 scale planes ``[L, N, P, K]``, codes starting at 0 and
    scales at 1.0, as JAX's ``make_cache`` makes them.

    One scratch slot lies just past the end of each buffer (and of each
    scale plane). A write that JAX drops with its past-the-end index (an
    unassigned page, a padded token, an inactive decode lane) lands there
    instead, so the write needs no mask and no device-to-host sync, and the
    device-resident decode loop stays free of host pulls. Nothing reads the
    scratch slot."""

    def __init__(
        self, cfg: ModelConfig, num_pages: int, page_size: int,
        dtype: torch.dtype, device: torch.device, kv_quantize: str = "",
    ):
        if kv_quantize not in KV_QUANTIZE_MODES:
            raise ValueError(f"kv_quantize={kv_quantize!r}: only 'int8' is supported")
        L, K, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim_
        self.num_pages, self.page_size = num_pages, page_size
        self.layer_slots = num_pages * page_size
        self.scratch = L * self.layer_slots
        shape = (L, num_pages, page_size, K)
        self.quantized = kv_quantize == "int8"
        store = torch.int8 if self.quantized else dtype
        self._k = torch.zeros(self.scratch + 1, K, D, dtype=store, device=device)
        self._v = torch.zeros_like(self._k)
        self.k = self._k[: self.scratch].view(*shape, D)
        self.v = self._v[: self.scratch].view(*shape, D)
        if self.quantized:
            self._ks = torch.ones(self.scratch + 1, K, dtype=torch.float32, device=device)
            self._vs = torch.ones_like(self._ks)
            self.k = QuantizedPages(self.k, self._ks[: self.scratch].view(shape))
            self.v = QuantizedPages(self.v, self._vs[: self.scratch].view(shape))

    def buffers(self) -> tuple[torch.Tensor, ...]:
        """The backing tensors. They are made once and only ever written
        in place: a captured decode step (``serving.decode_graph``) holds
        their addresses, so nothing may reallocate them."""
        if self.quantized:
            return self._k, self._v, self._ks, self._vs
        return self._k, self._v

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
        k_new, v_new = k_new.reshape(-1, K, D), v_new.reshape(-1, K, D)
        if self.quantized:
            (k_new, k_scale), (v_new, v_scale) = map(quantize_kv_rows, (k_new, v_new))
            self._ks.index_copy_(0, idx, k_scale)
            self._vs.index_copy_(0, idx, v_scale)
        self._k.index_copy_(0, idx, k_new)
        self._v.index_copy_(0, idx, v_new)


def _vector(n: int, dtype: torch.dtype, device: torch.device) -> nn.Parameter:
    return nn.Parameter(
        torch.empty(n, dtype=dtype, device=device), requires_grad=False
    )


def _linear(
    In: int, Out: int, dtype: torch.dtype, device: torch.device, quantize: str,
):
    """An uninitialized ``[In, Out]`` weight: a parameter in ``dtype``, or a
    quantized weight (int4 with one whole-axis scale group; loading a
    state dict brings its own group count)."""
    if quantize == "int8":
        return QuantizedLinear(
            torch.empty(In, Out, dtype=torch.int8, device=device),
            torch.empty(1, Out, dtype=torch.float32, device=device),
        )
    if quantize == "int4":
        return QuantizedLinear4(
            torch.empty(In // 2, Out, dtype=torch.int8, device=device),
            torch.empty(1, 1, Out, dtype=torch.float32, device=device),
        )
    return nn.Parameter(
        torch.empty(In, Out, dtype=dtype, device=device), requires_grad=False
    )


class DecoderLayer(nn.Module):
    def __init__(
        self, cfg: ModelConfig, dtype: torch.dtype, device: torch.device,
        quantize: str = "",
    ):
        super().__init__()
        d, f = cfg.hidden_size, cfg.intermediate_size

        def linear(In: int, Out: int):
            return _linear(In, Out, dtype, device, quantize)

        self.attn_norm = _vector(d, dtype, device)
        self.wq = linear(d, cfg.q_size)
        self.wk = linear(d, cfg.kv_size)
        self.wv = linear(d, cfg.kv_size)
        self.wo = linear(cfg.q_size, d)
        if cfg.attn_bias:
            self.bq = _vector(cfg.q_size, dtype, device)
            self.bk = _vector(cfg.kv_size, dtype, device)
            self.bv = _vector(cfg.kv_size, dtype, device)
        if cfg.qk_norm:
            self.qn = _vector(cfg.head_dim_, dtype, device)
            self.kn = _vector(cfg.head_dim_, dtype, device)
        self.mlp_norm = _vector(d, dtype, device)
        self.wg = linear(d, f)
        self.wu = linear(d, f)
        self.wd = linear(f, d)

    def qkv_rope(
        self, h: torch.Tensor, cfg: ModelConfig, cos: torch.Tensor,
        sin: torch.Tensor, plain: bool = False,
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        B, S, _ = h.shape
        K, D = cfg.num_kv_heads, cfg.head_dim_
        q, k, v = (_mm(h, w, plain) for w in (self.wq, self.wk, self.wv))
        if cfg.attn_bias:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        q, k = q.view(B, S, cfg.num_heads, D), k.view(B, S, K, D)
        if cfg.qk_norm:
            # Qwen3: per-head RMSNorm over the head dim, before RoPE.
            q = rms_norm(q, self.qn, cfg.rms_norm_eps)
            k = rms_norm(k, self.kn, cfg.rms_norm_eps)
        q = apply_rope(q, cos, sin)
        q_scale = _yarn_q_scale(cfg)
        if q_scale != 1.0:
            q = q * q_scale
        return q, apply_rope(k, cos, sin), v.view(B, S, K, D)

    def mlp(self, h: torch.Tensor, plain: bool = False) -> torch.Tensor:
        gate = F.silu(_mm(h, self.wg, plain)) * _mm(h, self.wu, plain)
        return _mm(gate, self.wd, plain)


class Llama(nn.Module):
    """Dense decoder. ``seed`` fills the weights with the fan-in-scaled
    normal init of ``opsagent_tpu``'s ``init_params`` (norms at 1, biases
    at 0), drawn on ``device`` from a ``torch.Generator``, so an 8B model is
    built on the card in seconds; ``seed=None`` leaves them uninitialized
    for ``load_state_dict``. ``quantize`` ("int8" or "int4") builds the
    projections and the lm_head as quantized weights, which a seed fills
    directly in quantized form (``init_random``). With tied embeddings
    there is no ``lm_head``: the head is ``x @ embed.T``, full precision
    under ``quantize`` too."""

    def __init__(
        self, cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16,
        device: str | torch.device | None = None, seed: int | None = 0,
        quantize: str = "",
    ):
        super().__init__()
        _check_supported(cfg)
        if quantize not in QUANTIZE_MODES:
            raise ValueError(
                f"quantize={quantize!r}: supported values are 'int8' "
                "(per-channel) and 'int4' (group-wise)"
            )
        device = resolve_device(device)
        self.cfg, self.dtype, self.quantize = cfg, dtype, quantize
        d, v = cfg.hidden_size, cfg.vocab_size
        self.embed = nn.Parameter(
            torch.empty(v, d, dtype=dtype, device=device), requires_grad=False
        )
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, dtype, device, quantize)
            for _ in range(cfg.num_layers)
        )
        self.final_norm = _vector(d, dtype, device)
        if not cfg.tie_embeddings:
            self.lm_head = _linear(d, v, dtype, device, quantize)
        if seed is not None:
            self.init_random(seed)

    @torch.no_grad()
    def init_random(self, seed: int) -> None:
        """Norms (and Qwen3's q/k norms) at 1, q/k/v biases at 0; the
        embedding and plain weights normal with std fan_in^-1/2; quantized
        weights as ``init_params_random_quantized`` makes them: uniform
        codes in [-127, 127] (int4: [-7, 7], packed, one whole-axis group)
        and one scale per tensor, chosen so the dequantized std matches the
        fan-in scaling. No full-precision copy of a quantized weight is
        ever built."""
        gen = torch.Generator(device=self.embed.device).manual_seed(seed)
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf.endswith("norm") or leaf in ("qn", "kn"):
                p.fill_(1.0)
                continue
            if leaf in ("bq", "bk", "bv"):
                p.zero_()
                continue
            # Fan-in is the contraction dim: [in, out] weights, and the
            # embedding's row width.
            fan_in = p.shape[1] if name == "embed" else p.shape[0]
            p.copy_(
                torch.randn(
                    p.shape, generator=gen, device=p.device, dtype=torch.float32
                ).mul_(fan_in ** -0.5)
            )
        for w in self.modules():
            if not isinstance(w, QuantizedBase):
                continue
            In, Out = w.shape
            top = 7 if isinstance(w, QuantizedLinear4) else 127
            codes = torch.randint(
                -top, top + 1, (In, Out), generator=gen, device=w.q.device,
                dtype=torch.int8,
            )
            w.q.copy_(pack_int4(codes) if top == 7 else codes)
            # std(U[-top, top]) = top / sqrt(3), matched to fan_in^-1/2.
            w.scale.fill_(In ** -0.5 * 3.0 ** 0.5 / top)
            del codes

    def make_cache(
        self, num_pages: int, page_size: int, kv_quantize: str = "",
    ) -> PagedKVCache:
        return PagedKVCache(
            self.cfg, num_pages, page_size, self.dtype, self.embed.device,
            kv_quantize,
        )

    def _rope(self, positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return rope_table(
            positions, self.cfg.head_dim_, self.cfg.rope_theta, self.cfg.rope_scaling
        )

    def _run_stack(self, x: torch.Tensor, attn_fn, plain: bool) -> torch.Tensor:
        eps = self.cfg.rms_norm_eps
        for li, layer in enumerate(self.layers):
            h = rms_norm(x, layer.attn_norm, eps)
            x = x + _mm(attn_fn(h, layer, li), layer.wo, plain)
            x = x + layer.mlp(rms_norm(x, layer.mlp_norm, eps), plain)
        return x

    def _lm_head(self, x: torch.Tensor, plain: bool) -> torch.Tensor:
        x = rms_norm(x, self.final_norm, self.cfg.rms_norm_eps)
        if self.cfg.tie_embeddings:
            return (x @ self.embed.T.to(x.dtype)).float()
        return _mm(x, self.lm_head, plain).float()

    def forward_full(self, tokens: torch.Tensor) -> torch.Tensor:
        """All-positions logits [B, S, V] f32: plain causal attention over
        the fresh sequence, no cache."""
        B, S = tokens.shape
        pos = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
        cos, sin = self._rope(pos)

        def attn_fn(h, layer, li):
            q, k, v = layer.qkv_rope(h, self.cfg, cos, sin, plain=True)
            return causal_prefill_attention(q, k, v).reshape(B, S, -1)

        x = self._run_stack(self.embed[tokens].to(self.dtype), attn_fn, True)
        return self._lm_head(x, True)

    def mixed_step(
        self,
        tokens: torch.Tensor,       # [B, S] int ragged rows, right-padded
        start: torch.Tensor,        # [B] int32 write offsets
        q_lens: torch.Tensor,       # [B] int32 valid rows (0 = inactive)
        cache: PagedKVCache,
        page_table: torch.Tensor,   # [B, MaxP] int32
        plain: bool = False,
        backend: str = "dma",
    ) -> torch.Tensor:
        """One forward over decode rows (q_len 1) and prefill chunks (q_len
        up to S) together: writes each row's valid K/V at ``start`` and
        returns the logits of its last valid position [B, V] f32. Rows with
        q_len 0 write nothing; their logits are discarded by the caller.
        ``backend`` picks the paged-attention kernels ("dma" or "grid");
        ``plain`` runs attention and the quantized matmuls through their
        plain PyTorch versions."""
        ragged_attention = PAGED_BACKENDS[backend][0]
        B, S = tokens.shape
        pos = start.long()[:, None] + torch.arange(S, device=tokens.device)[None, :]
        cos, sin = self._rope(pos)
        flat = flat_slot_indices(
            page_table, start, S, cache.page_size, cache.num_pages,
            valid_len=q_lens,
        ).reshape(-1)

        def attn_fn(h, layer, li):
            q, k, v = layer.qkv_rope(h, self.cfg, cos, sin, plain)
            cache.write(li, k, v, flat)
            # cache.k[li] is a view: the attention reads the rows just written.
            attn = ragged_attention(
                q, cache.k[li], cache.v[li], page_table, start, q_lens,
                plain=plain,
            )
            return attn.reshape(B, S, -1)

        x = self._run_stack(self.embed[tokens].to(self.dtype), attn_fn, plain)
        last = (q_lens.long() - 1).clamp(0, S - 1)
        return self._lm_head(x[torch.arange(B, device=x.device), last], plain)

    def decode_step(
        self,
        tokens: torch.Tensor,       # [B] int latest sampled token per row
        lengths: torch.Tensor,      # [B] int32 tokens already in cache
        cache: PagedKVCache,
        page_table: torch.Tensor,   # [B, MaxP] int32
        active: torch.Tensor,       # [B] bool; inactive rows write nothing
        plain: bool = False,
        backend: str = "dma",
    ) -> torch.Tensor:
        """One token per sequence: writes its K/V at ``lengths`` and returns
        the next-token logits [B, V] f32 (``backend`` and ``plain`` as in
        ``mixed_step``)."""
        decode_attention = PAGED_BACKENDS[backend][1]
        B = tokens.shape[0]
        cos, sin = self._rope(lengths.long()[:, None])
        valid = active.to(torch.int32)
        flat = flat_slot_indices(
            page_table, lengths, 1, cache.page_size, cache.num_pages,
            valid_len=valid,
        ).reshape(-1)
        seen = (lengths + valid).to(torch.int32)

        def attn_fn(h, layer, li):
            q, k, v = layer.qkv_rope(h, self.cfg, cos, sin, plain)
            cache.write(li, k, v, flat)
            # cache.k[li] is a view: the attention reads the row just written.
            attn = decode_attention(
                q[:, 0], cache.k[li], cache.v[li], page_table, seen,
                plain=plain,
            )
            return attn.reshape(B, 1, -1)

        x = self._run_stack(
            self.embed[tokens[:, None]].to(self.dtype), attn_fn, plain
        )
        return self._lm_head(x[:, 0], plain)
