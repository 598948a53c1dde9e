"""Llama-family decoder (GQA + RoPE + SwiGLU + RMSNorm) in PyTorch, with
DeepSeek-style mixture-of-experts MLPs and multi-head latent attention.

The port's counterpart of ``opsagent_tpu/models/llama.py``: Llama and
Mistral, Qwen2's q/k/v biases, Qwen3's per-head q/k RMSNorm, tied
embeddings, llama3/YaRN rope scaling; MoE layers after ``moe_layer_start``
dense ones (DeepSeek-MoE, Qwen3-MoE, DeepSeek-V2/V3: softmax or sigmoid
routing, group-limited top-k, shared experts, the all-experts form the JAX
engine serves with); MLA (DeepSeek-V2/V3), materialized or, with
``latent_cache``, over a cache of one latent per token in the
weight-absorbed form. Weights keep the JAX orientation (``x @ w`` with
``w`` ``[in, out]``; expert weights stacked ``[E, in, out]`` per layer), so
a JAX parameter tree carries across unchanged (``models.convert``) and an
HF checkpoint loads with its matrices transposed (``models.loader``). The
layer stack is a Python loop over ``nn.Module`` layers where JAX scans
stacked arrays.

Entry points over the same weights:

- ``mixed_step``: ragged rows (decode rows at q_len 1 beside prefill chunks)
  over the paged cache, through the ragged paged-attention kernel of the
  chosen backend ("dma" or "grid", ``ops.paged_attention.PAGED_BACKENDS``);
- ``decode_step``: one token per sequence, through that backend's decode
  kernel;
- ``prefill_with_prefix``: the split prefill lane's chunks (JAX's, over the
  ragged contract with ``q_lens = lengths``), through the same ragged
  kernel; ``prefill``: JAX's fresh-prompt form over the fresh K/V, plain
  PyTorch, which the engine does not call;
- ``verify_step``: a speculative draft chunk per row over the paged cache,
  through the same ragged kernel, with the logits of every chunk position;
- ``forward_full``: all positions, plain causal attention, no cache (the
  oracle and the training loss path, with ``remat`` to recompute each
  layer's activations in the backward). A MoE layer there switches to the
  capacity-bucketed grouped dispatch (``_moe_grouped_dispatch``) once a
  forward holds ``grouped_dispatch_min_tokens`` tokens, as JAX's does.

With ``quantize="int8"`` or ``"int4"`` every projection, each expert's
and the lm_head are ``models.quant`` weights, and ``_mm`` sends them
through the quantized matmul kernel, one 2-D expert slice a call; the
cache made with ``kv_quantize="int8"`` holds int8 pages with per-(token, kv
head) scales, which the attention kernels read (not with MLA, as in JAX).

With a ``mesh`` (``parallel.mesh``) the model is this rank's shard, placed
as JAX's ``param_specs`` / ``cache_specs`` / ``quantize_specs`` place it
(the port's copies below): Megatron column-parallel ``wq``/``wk``/``wv``/
``wg``/``wu`` (and ``bq``/``bk``/``bv``, MLA's ``wq``/``wuq``/``wukv``, the
shared experts' ``sg``/``su``) hold H/tp heads or f/tp columns; the
row-parallel ``wo``/``wd``/``sd`` and the experts' ``ed`` hold their input
rows, each followed by an all-reduce over ``tp``; the routed experts' ``E``
axis shards over ``ep`` (E/ep experts of fe/tp columns; their weighted sum
is all-reduced over ``ep``); the embedding holds V/tp rows (a lookup masks
the ids outside them, then all-reduces) and the head V/tp columns (the
logits all-gathered over ``tp``). The router, the norms, MLA's ``wdq``/
``wdkv``/``wkr`` and its latent cache are whole on every rank; GQA pages
hold K/tp kv heads. Each rank's attention runs the hand-written kernels on
its own heads (``ops.paged_attention``'s ``*_tp`` wrappers), its
column-parallel quantized products through ``quant_matmul_tp``.
"""

from __future__ import annotations

import math
from functools import partial

import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..ops.attention import (
    QuantizedPages,
    causal_prefill_attention,
    flat_slot_indices,
    paged_prefix_attention,
    quantize_kv_rows,
)
from ..ops.paged_attention import (
    PAGED_BACKENDS,
    paged_decode_attention_tp,
    paged_ragged_attention_tp,
)
from ..ops.quant_matmul import quant_matmul_cuda, quant_matmul_tp
from ..ops.rope import apply_rope, rope_table, yarn_get_mscale
from ..parallel.collectives import all_gather, gather, reduce_sum, replicate
from ..parallel.mesh import AXES, Mesh, shard_tensor
from .config import ModelConfig
from .quant import (
    QuantizedBase,
    QuantizedLinear,
    QuantizedLinear4,
    pack_int4,
    quantize_specs,
)

QUANTIZE_MODES = ("", "int8", "int4")
KV_QUANTIZE_MODES = ("", "int8")


def _layer_split(cfg: ModelConfig) -> tuple[int, int]:
    """(dense layer count, MoE layer count): dense layers come first."""
    if cfg.moe is None:
        return cfg.num_layers, 0
    return cfg.moe_layer_start, cfg.num_layers - cfg.moe_layer_start


def _latent_cache(cfg: ModelConfig) -> bool:
    return cfg.mla is not None and cfg.mla.latent_cache


def _check_mla(cfg: ModelConfig) -> None:
    m = cfg.mla
    if m is None:
        return
    if cfg.head_dim_ != m.qk_head_dim:
        raise ValueError(
            f"mla: head_dim={cfg.head_dim_} must equal qk_head_dim={m.qk_head_dim}"
        )
    if cfg.num_kv_heads != cfg.num_heads:
        raise ValueError("mla: num_kv_heads must equal num_heads (no GQA)")


def check_stages(cfg: ModelConfig, pp: int) -> None:
    """JAX's pipeline checks: the stack that pipelines (the layers, or a
    MoE model's MoE layers) divides over ``pp``."""
    if pp <= 1:
        return
    if cfg.moe is not None:
        _, lm = _layer_split(cfg)
        if lm % pp:
            raise ValueError(f"moe layers {lm} not divisible by pp={pp}")
    elif cfg.num_layers % pp:
        raise ValueError(f"num_layers={cfg.num_layers} not divisible by pp={pp}")


def stage_layers(cfg: ModelConfig, mesh: Mesh | None) -> list[int]:
    """The layers this rank's pipeline stage holds (JAX's ``param_specs_pp``
    over the stacked axis): every layer at pp = 1; otherwise stage s's L/pp
    consecutive layers, or for a MoE model the dense prefix (replicated
    over pp; it runs on stage 0) and stage s's share of the MoE layers."""
    pp = 1 if mesh is None else mesh.shape[AXES.pp]
    if pp == 1:
        return list(range(cfg.num_layers))
    check_stages(cfg, pp)
    dense, n = _layer_split(cfg)
    first, s = (dense, n) if cfg.moe is not None else (0, cfg.num_layers)
    per = s // pp
    stage = mesh.coords[AXES.pp]
    return list(range(first)) + list(range(first + stage * per, first + (stage + 1) * per))


def staged(cfg: ModelConfig, name: str) -> bool:
    """Whether the state entry ``name`` lies on the pipelined stack (split
    over pp) rather than replicated over pp."""
    if not name.startswith("layers."):
        return False
    return cfg.moe is None or int(name.split(".")[1]) >= _layer_split(cfg)[0]


def _check_shards(cfg: ModelConfig, mesh: Mesh | None) -> None:
    """Raise unless every sharded dimension of ``cfg`` divides over its
    mesh axis (heads, kv heads, vocab, MLP widths over ``tp``; experts over
    ``ep``; the pipelined stack over ``pp``)."""
    if mesh is None:
        return
    tp, ep = mesh.shape[AXES.tp], mesh.shape[AXES.ep]
    check_stages(cfg, mesh.shape[AXES.pp])
    dims = {"num_heads": (cfg.num_heads, tp), "num_kv_heads": (cfg.num_kv_heads, tp),
            "vocab_size": (cfg.vocab_size, tp),
            "intermediate_size": (cfg.intermediate_size, tp)}
    if cfg.moe is not None:
        m = cfg.moe
        dims["num_experts"] = (m.num_experts, ep)
        fe = m.expert_intermediate_size or cfg.intermediate_size
        dims["expert_intermediate_size"] = (fe, tp)
    elif ep > 1:
        raise ValueError(f"ep={ep} needs a MoE model; {cfg.name} has no experts")
    for name, (size, n) in dims.items():
        if size % n:
            raise ValueError(f"{cfg.name}: {name}={size} does not divide over {n} ranks")


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


def _col(x: torch.Tensor, w, plain: bool, tp: int) -> torch.Tensor:
    """A column-parallel product: ``_mm``, a quantized weight's through
    ``quant_matmul_tp`` when its columns shard over ``tp`` > 1."""
    if tp > 1 and isinstance(w, QuantizedBase):
        y = quant_matmul_tp(x.reshape(-1, x.shape[-1]), w, plain=plain)
        return y.reshape(*x.shape[:-1], y.shape[-1])
    return _mm(x, w, plain)


def _ein(x: torch.Tensor, w) -> torch.Tensor:
    """Batched expert product ``[E, C, in] @ [E, in, out]`` (JAX's ``_ein``):
    a quantized stack is dequantized to x's dtype first. JAX keeps stacked
    leaves on XLA, never on its quantized matmul kernel, so this is plain
    PyTorch on the card too."""
    if isinstance(w, QuantizedBase):
        w = w.dequantize().to(x.dtype)
    return torch.bmm(x, w)


def _dense_weight(w) -> torch.Tensor:
    """A weight that code reshapes or slices (the absorbed MLA path reads
    wukv per head): a quantized one dequantized (f32), as JAX's
    ``_dense_weight``."""
    return w.dequantize() if isinstance(w, QuantizedBase) else w


def _expert(w, e: int):
    """Expert ``e``'s 2-D slice of a stacked ``[E, In, Out]`` weight: a view
    of the parameter, or a quantized weight over views of its codes and
    scales."""
    if isinstance(w, QuantizedBase):
        return type(w)(w.q[e], w.scale[e])
    return w[e]


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype) * w


# -- placement (the port's copies of JAX's spec tables) ------------------------
# A spec is a tuple of one mesh axis name or None per dimension of a leaf
# of JAX's parameter tree (stacked leaves lead with their layer axis).
def _attn_block_specs(cfg: ModelConfig) -> dict[str, tuple]:
    """JAX's ``_attn_block_specs``."""
    if cfg.mla is not None:
        # Megatron MLA: wuq/wq/wukv column-parallel over heads, wo
        # row-parallel; the down-projections and the shared rope key
        # replicated.
        block = {
            "attn_norm": (None, None),
            "wdkv": (None, None, None),
            "wkr": (None, None, None),
            "kv_norm": (None, None),
            "wukv": (None, None, "tp"),
            "wo": (None, "tp", None),
            "mlp_norm": (None, None),
        }
        if cfg.mla.q_lora_rank:
            block["wdq"] = (None, None, None)
            block["q_norm"] = (None, None)
            block["wuq"] = (None, None, "tp")
        else:
            block["wq"] = (None, None, "tp")
        return block
    block = {
        "attn_norm": (None, None),
        "wq": (None, None, "tp"),
        "wk": (None, None, "tp"),
        "wv": (None, None, "tp"),
        "wo": (None, "tp", None),
        "mlp_norm": (None, None),
    }
    if cfg.attn_bias:
        block["bq"] = (None, "tp")
        block["bk"] = (None, "tp")
        block["bv"] = (None, "tp")
    if cfg.qk_norm:
        # Per-head-dim vectors: replicated.
        block["qn"] = (None, None)
        block["kn"] = (None, None)
    return block


def param_specs(cfg: ModelConfig) -> dict:
    """JAX's ``param_specs``: column-parallel wq/wk/wv/wg/wu over ``tp``,
    row-parallel wo/wd; the experts' E axis over ``ep`` and their
    intermediate axis over ``tp``; the embedding over vocab rows, the
    lm_head over vocab columns."""
    layers = _attn_block_specs(cfg)
    layers.update({"wg": (None, None, "tp"), "wu": (None, None, "tp"),
                   "wd": (None, "tp", None)})
    specs: dict = {"embed": ("tp", None), "layers": layers, "final_norm": (None,)}
    _, Lm = _layer_split(cfg)
    if Lm:
        moe_layers = _attn_block_specs(cfg)
        if cfg.moe.scoring_func == "sigmoid":
            moe_layers["router_bias"] = (None, None)
        moe_layers.update({
            "router": (None, None, None),
            "eg": (None, "ep", None, "tp"),
            "eu": (None, "ep", None, "tp"),
            "ed": (None, "ep", "tp", None),
        })
        if cfg.moe.num_shared_experts:
            moe_layers["sg"] = (None, None, "tp")
            moe_layers["su"] = (None, None, "tp")
            moe_layers["sd"] = (None, "tp", None)
        specs["moe_layers"] = moe_layers
    if not cfg.tie_embeddings:
        specs["lm_head"] = (None, "tp")
    return specs


def cache_specs(cfg: ModelConfig, kv_quantize: str = "") -> dict:
    """JAX's ``cache_specs``: pages over the kv-head axis; int8 scale
    planes with their values; the MLA latent cache replicated."""
    if _latent_cache(cfg):
        return {"k": (None,) * 5, "v": (None,) * 5}
    if kv_quantize:
        spec = {"q": (None, None, None, "tp", None), "scale": (None, None, None, "tp")}
        return {"k": spec, "v": spec}
    return {"k": (None, None, None, "tp", None), "v": (None, None, None, "tp", None)}


def state_specs(cfg: ModelConfig, quantize: str = "") -> dict[str, tuple]:
    """The spec of every entry of a ``Llama`` state dict (layer leaves
    without JAX's layer axis; a quantized weight's ``.q`` and ``.scale`` by
    ``quantize_specs``)."""
    specs = param_specs(cfg)
    if quantize:
        specs = quantize_specs(specs, quantize)
    dense, _ = _layer_split(cfg)
    out: dict[str, tuple] = {}

    def add(key: str, spec, drop: int) -> None:
        if isinstance(spec, dict):
            for part, s in spec.items():
                out[f"{key}.{part}"] = tuple(s)[drop:]
        else:
            out[key] = tuple(spec)[drop:]

    for name in ("embed", "final_norm", "lm_head"):
        if name in specs:
            add(name, specs[name], 0)
    for i in range(cfg.num_layers):
        stack = specs["moe_layers" if i >= dense else "layers"]
        for name, spec in stack.items():
            add(f"layers.{i}.{name}", spec, 1)
    return out


def _row_sharded(spec: tuple) -> str | None:
    """The axis a ``[..., In, Out]`` weight's contraction rows shard over."""
    return spec[-2] if len(spec) >= 2 else None


def split_int4_scales(state: dict[str, torch.Tensor], cfg: ModelConfig, mesh: Mesh | None,
                      quantize: str = "") -> set[str]:
    """The int4 scale keys of a full state dict whose groups ``local_state``
    splits over the contraction rows' axis (several groups, rows sharded):
    the others keep their one whole-axis group on every rank."""
    if quantize != "int4" or mesh is None or mesh.size == 1:
        return set()
    specs = state_specs(cfg, quantize)
    out = set()
    for key, t in state.items():
        if key.endswith(".scale") and key in specs:
            axis = _row_sharded(specs[key[: -len("scale")] + "q"])
            if axis is not None and mesh.shape[axis] > 1 and t.shape[-3] > 1:
                out.add(key)
    return out


def local_state(state: dict[str, torch.Tensor], cfg: ModelConfig, mesh: Mesh | None,
                quantize: str = "") -> dict[str, torch.Tensor]:
    """This rank's shards of a full ``Llama`` state dict (``shard_params``
    by ``state_specs``; at pp > 1 only the layers of this rank's stage,
    ``stage_layers``). An int4 weight whose contraction rows shard keeps
    the scale groups of its rows: its group size must divide In/tp, else
    a group would straddle two ranks and this raises; a weight with one
    whole-axis group keeps that group on every rank."""
    if mesh is None or mesh.size == 1:
        return state
    specs = state_specs(cfg, quantize)
    held = set(stage_layers(cfg, mesh))
    out: dict[str, torch.Tensor] = {}
    for key, t in state.items():
        if key.startswith("layers.") and int(key.split(".")[1]) not in held:
            continue
        spec = specs[key]
        if quantize == "int4" and key.endswith(".scale"):
            axis = _row_sharded(specs[key[: -len("scale")] + "q"])
            n = 1 if axis is None else mesh.shape[axis]
            G = t.shape[-3]
            if n > 1 and G > 1:
                if G % n:
                    raise ValueError(
                        f"{key}: {G} int4 scale groups do not divide over {axis}={n}: "
                        "a group would straddle a shard boundary (the group size "
                        "must divide In/tp)")
                spec = (*spec[:-3], axis, *spec[-2:])
        out[key] = shard_tensor(t, spec, mesh)
    return out


def _full_shape(shape, spec: tuple, mesh: Mesh | None) -> tuple[int, ...]:
    """A shard's full shape under ``spec``."""
    if mesh is None:
        return tuple(shape)
    return tuple(s * (1 if d >= len(spec) or spec[d] is None else mesh.shape[spec[d]])
                 for d, s in enumerate(shape))


def _reduce(x: torch.Tensor, mesh: Mesh | None, axis: str) -> torch.Tensor:
    """The sum of a partial result over ``axis`` (x itself at one rank); in
    training its gradient passes through (``collectives.reduce_sum``)."""
    return reduce_sum(x, mesh, axis)


class PagedKVCache:
    """The paged KV cache: ``k`` and ``v`` are ``[L, N, P, K, D]``, the JAX
    layout, and attention reads the contiguous per-layer view
    ``k[layer]``. Writes update the buffers in place. With
    ``kv_quantize="int8"``, ``k`` and ``v`` are ``QuantizedPages``: int8
    pages and f32 scale planes ``[L, N, P, K]``, codes starting at 0 and
    scales at 1.0, as JAX's ``make_cache`` makes them. The MLA latent
    layout (JAX's too) holds one latent per token, ``k`` ``[L, N, P, 1,
    DL]``, which attention reads as both keys and values, beside a
    ``[L, N, P, 1, 1]`` placeholder ``v`` that nothing writes. At ``tp`` > 1
    each rank holds its K/tp kv heads (the scale planes with them); the
    latent cache is whole on every rank (``cache_specs``).

    One scratch slot lies just past the end of each buffer (and of each
    scale plane). A write that JAX drops with its past-the-end index (an
    unassigned page, a padded token, an inactive decode lane) lands there
    instead, so the write needs no mask and no device-to-host sync, and the
    device-resident decode loop stays free of host pulls. Nothing reads the
    scratch slot."""

    def __init__(
        self, cfg: ModelConfig, num_pages: int, page_size: int,
        dtype: torch.dtype, device: torch.device, kv_quantize: str = "",
        tp: int = 1,
    ):
        if kv_quantize not in KV_QUANTIZE_MODES:
            raise ValueError(f"kv_quantize={kv_quantize!r}: only 'int8' is supported")
        if kv_quantize and cfg.mla is not None:
            raise ValueError("kv_quantize is not supported for MLA models")
        L = cfg.num_layers
        self.latent = _latent_cache(cfg)
        if self.latent:
            K, D, Dv = 1, cfg.mla.latent_dim, 1
        else:
            if cfg.num_kv_heads % tp:
                raise ValueError(f"{cfg.num_kv_heads} kv heads do not divide over tp={tp}")
            K, D = cfg.num_kv_heads // tp, cfg.head_dim_
            Dv = D
        self.num_pages, self.page_size = num_pages, page_size
        self.layer_slots = num_pages * page_size
        self.scratch = L * self.layer_slots
        shape = (L, num_pages, page_size, K)
        self.quantized = kv_quantize == "int8"
        store = torch.int8 if self.quantized else dtype
        self._k = torch.zeros(self.scratch + 1, K, D, dtype=store, device=device)
        self._v = torch.zeros(self.scratch + 1, K, Dv, dtype=store, device=device)
        self.k = self._k[: self.scratch].view(*shape, D)
        self.v = self._v[: self.scratch].view(*shape, Dv)
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

    def page_leaves(self) -> dict[str, torch.Tensor]:
        """The ``[L, N, P, ...]`` views of the pages (never the scratch
        slot), named and ordered as the JAX package's cache tree flattens:
        ``k``, ``v``; for int8 pages ``k.q``, ``k.scale``, ``v.q``,
        ``v.scale``. The views share the buffers, so an in-place write to
        one writes the cache (the host KV tier's page copies)."""
        if self.quantized:
            return {"k.q": self.k.q, "k.scale": self.k.scale,
                    "v.q": self.v.q, "v.scale": self.v.scale}
        return {"k": self.k, "v": self.v}

    def write(
        self, layer: int, k_new: torch.Tensor, v_new: torch.Tensor | None,
        flat: torch.Tensor,
    ) -> None:
        """Write ``[B, S, K, D]`` rows at layer-local flat slots ``flat``
        (``[B * S]``, from ``flat_slot_indices`` with ``total=N``, where
        ``N * P`` marks a dropped row), in place. The latent layout writes
        ``k_new`` alone (``v_new`` None), as JAX's ``write_pages``."""
        idx = torch.where(
            flat < self.layer_slots, flat + layer * self.layer_slots,
            self.scratch,
        )
        K, D = self._k.shape[1:]
        k_new = k_new.reshape(-1, K, D)
        if v_new is None:
            self._k.index_copy_(0, idx, k_new.to(self._k.dtype))
            return
        v_new = v_new.reshape(-1, K, D)
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
    lead: tuple[int, ...] = (),
):
    """An uninitialized ``[*lead, In, Out]`` weight (``lead`` = (E,) for
    stacked experts): a parameter in ``dtype``, or a quantized weight (int4
    with one whole-axis scale group; loading a state dict brings its own
    group count)."""
    if quantize == "int8":
        return QuantizedLinear(
            torch.empty(*lead, In, Out, dtype=torch.int8, device=device),
            torch.empty(*lead, 1, Out, dtype=torch.float32, device=device),
        )
    if quantize == "int4":
        return QuantizedLinear4(
            torch.empty(*lead, In // 2, Out, dtype=torch.int8, device=device),
            torch.empty(*lead, 1, 1, Out, dtype=torch.float32, device=device),
        )
    return nn.Parameter(
        torch.empty(*lead, In, Out, dtype=dtype, device=device), requires_grad=False
    )


class DecoderLayer(nn.Module):
    """One layer: attention (GQA, or MLA with ``cfg.mla``) and an MLP, dense
    or, with ``moe``, the routed experts stacked ``[E, in, out]`` (and the
    shared experts) of ``cfg.moe``. With a ``mesh``, this rank's shard of
    it (the module docstring)."""

    def __init__(
        self, cfg: ModelConfig, dtype: torch.dtype, device: torch.device,
        quantize: str = "", moe: bool = False, mesh: Mesh | None = None,
    ):
        super().__init__()
        tp = 1 if mesh is None else mesh.shape[AXES.tp]
        ep = 1 if mesh is None else mesh.shape[AXES.ep]
        d, f = cfg.hidden_size, cfg.intermediate_size // tp
        self.moe, self.mesh, self.tp = moe, mesh, tp
        # This rank's query and kv heads.
        self.heads, self.kv_heads = cfg.num_heads // tp, cfg.num_kv_heads // tp

        def linear(In: int, Out: int, lead: tuple[int, ...] = ()):
            return _linear(In, Out, dtype, device, quantize, lead)

        self.attn_norm = _vector(d, dtype, device)
        if cfg.mla is not None:
            m, H = cfg.mla, self.heads
            dq = m.qk_head_dim
            if m.q_lora_rank:
                self.wdq = linear(d, m.q_lora_rank)                  # q_a_proj
                self.q_norm = _vector(m.q_lora_rank, dtype, device)  # q_a_layernorm
                self.wuq = linear(m.q_lora_rank, H * dq)             # q_b_proj
            else:
                self.wq = linear(d, H * dq)                          # q_proj
            self.wdkv = linear(d, m.kv_lora_rank)  # kv_a_proj_with_mqa[:rkv]
            self.wkr = linear(d, m.qk_rope_head_dim)  # kv_a_proj_with_mqa[rkv:]
            self.kv_norm = _vector(m.kv_lora_rank, dtype, device)
            self.wukv = linear(m.kv_lora_rank, H * (m.qk_nope_head_dim + m.v_head_dim))
            # o_proj over the padded head dim: the pad rows meet v's zeros.
            self.wo = linear(H * dq, d)
        else:
            q_size, kv_size = cfg.q_size // tp, cfg.kv_size // tp
            self.wq = linear(d, q_size)
            self.wk = linear(d, kv_size)
            self.wv = linear(d, kv_size)
            self.wo = linear(q_size, d)
            if cfg.attn_bias:
                self.bq = _vector(q_size, dtype, device)
                self.bk = _vector(kv_size, dtype, device)
                self.bv = _vector(kv_size, dtype, device)
            if cfg.qk_norm:
                self.qn = _vector(cfg.head_dim_, dtype, device)
                self.kn = _vector(cfg.head_dim_, dtype, device)
        self.mlp_norm = _vector(d, dtype, device)
        if not moe:
            self.wg = linear(d, f)
            self.wu = linear(d, f)
            self.wd = linear(f, d)
            return
        m = cfg.moe
        fe, E = (m.expert_intermediate_size or cfg.intermediate_size) // tp, m.num_experts
        # The router stays f32: tiny, and top-k is precision-sensitive.
        self.router = nn.Parameter(
            torch.empty(d, E, dtype=torch.float32, device=device), requires_grad=False
        )
        if m.scoring_func == "sigmoid":
            self.router_bias = _vector(E, torch.float32, device)
        # This rank's experts: E/ep of them, from expert0 on.
        self.expert0 = (0 if mesh is None else mesh.coords[AXES.ep]) * (E // ep)
        self.eg = linear(d, fe, (E // ep,))
        self.eu = linear(d, fe, (E // ep,))
        self.ed = linear(fe, d, (E // ep,))
        if m.num_shared_experts:
            fs = fe * m.num_shared_experts
            self.sg = linear(d, fs)
            self.su = linear(d, fs)
            self.sd = linear(fs, d)

    def qkv_rope(
        self, h: torch.Tensor, cfg: ModelConfig, cos: torch.Tensor,
        sin: torch.Tensor, plain: bool = False,
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """q/k/v with RoPE applied (materialized under MLA), per head."""
        if cfg.mla is not None:
            return self.qkv_mla(h, cfg, cos, sin, plain)
        B, S, _ = h.shape
        K, D = self.kv_heads, cfg.head_dim_
        h = self.enter(h)
        q, k, v = (self.col(h, w, plain) for w in (self.wq, self.wk, self.wv))
        if cfg.attn_bias:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        q, k = q.view(B, S, self.heads, D), k.view(B, S, K, D)
        if cfg.qk_norm:
            # Qwen3: per-head RMSNorm over the head dim, before RoPE (the
            # whole weight on this rank's heads).
            q = rms_norm(q, self.enter(self.qn), cfg.rms_norm_eps)
            k = rms_norm(k, self.enter(self.kn), cfg.rms_norm_eps)
        q = apply_rope(q, cos, sin)
        q_scale = _yarn_q_scale(cfg)
        if q_scale != 1.0:
            q = q * q_scale
        return q, apply_rope(k, cos, sin), v.view(B, S, K, D)

    # -- MLA (JAX's _mla_q, _mla_kv_latent, _qkv_mla, _mla_latent_parts,
    #    _mla_latent_out) ---------------------------------------------------
    def mla_q(self, h, cfg: ModelConfig, cos, sin, plain: bool = False):
        """(q_nope [B, S, H, dn], roped q_rope [B, S, H, dr])."""
        m = cfg.mla
        B, S, _ = h.shape
        dn, dr = m.qk_nope_head_dim, m.qk_rope_head_dim
        if m.q_lora_rank:
            cq = rms_norm(_mm(h, self.wdq, plain), self.q_norm, cfg.rms_norm_eps)
            q = self.col(self.enter(cq), self.wuq, plain)
        else:
            q = self.col(self.enter(h), self.wq, plain)
        q = q.view(B, S, self.heads, dn + dr)
        return q[..., :dn], apply_rope(q[..., dn:], cos, sin)

    def mla_kv_latent(self, h, cfg: ModelConfig, cos, sin, plain: bool = False):
        """(normed kv latent [B, S, rkv], roped shared key [B, S, 1, dr])."""
        B, S, _ = h.shape
        ckv = rms_norm(_mm(h, self.wdkv, plain), self.kv_norm, cfg.rms_norm_eps)
        k_rope = apply_rope(
            _mm(h, self.wkr, plain).view(B, S, 1, cfg.mla.qk_rope_head_dim), cos, sin
        )
        return ckv, k_rope

    def qkv_mla(self, h, cfg: ModelConfig, cos, sin, plain: bool = False,
                with_latent: bool = False):
        """Materialized MLA (q, k, v): per-head k_nope and v from the
        latent's up-projection, the shared rope key broadcast over the
        heads, v zero-padded to the qk head dim. ``with_latent`` also
        returns the token's latent [c, k_rope] [B, S, 1, DL] (JAX's
        ``_qkv_mla(with_latent=True)``)."""
        m = cfg.mla
        B, S, _ = h.shape
        H, dn, dr, dv = self.heads, m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
        q_nope, q_rope = self.mla_q(h, cfg, cos, sin, plain)
        q = torch.cat([q_nope, q_rope], dim=-1) * _yarn_q_scale(cfg)
        ckv, k_rope = self.mla_kv_latent(h, cfg, cos, sin, plain)
        kv = self.col(self.enter(ckv), self.wukv, plain).view(B, S, H, dn + dv)
        # The shared rope key meets this rank's heads only.
        k = torch.cat([kv[..., :dn], self.enter(k_rope).expand(B, S, H, dr)], dim=-1)
        v = torch.cat([kv[..., dn:], kv.new_zeros(B, S, H, dn + dr - dv)], dim=-1)
        if with_latent:
            latent = torch.cat([ckv[:, :, None, :], k_rope], dim=-1).to(h.dtype)
            return q, k, v, latent
        return q, k, v

    def mla_latent_parts(self, h, cfg: ModelConfig, cos, sin, plain: bool = False):
        """The weight-absorbed form over the latent cache: (q_lat [B, S, H,
        DL], latent [B, S, 1, DL]). q_lat[h] = [W_uk^T q_nope[h], q_rope[h]]
        dotted with a token's latent [c, k_rope] gives that head's score;
        attention scales by DL^-1/2, so q_lat carries sqrt(DL / dq) and
        YaRN's correction to restore dq^-1/2."""
        m = cfg.mla
        H, dn, dv, rkv = self.heads, m.qk_nope_head_dim, m.v_head_dim, m.kv_lora_rank
        q_nope, q_rope = self.mla_q(h, cfg, cos, sin, plain)
        w = _dense_weight(self.wukv)
        ct = torch.promote_types(q_nope.dtype, w.dtype)
        w_uk = w.to(ct).view(rkv, H, dn + dv)[:, :, :dn]
        q_abs = torch.einsum("bshd,rhd->bshr", q_nope.to(ct), w_uk)
        scale = (m.latent_dim ** 0.5) / (m.qk_head_dim ** 0.5) * _yarn_q_scale(cfg)
        q_lat = torch.cat([q_abs, q_rope.to(ct)], dim=-1) * scale
        ckv, k_rope = self.mla_kv_latent(h, cfg, cos, sin, plain)
        latent = torch.cat([ckv[:, :, None, :], k_rope], dim=-1)
        return q_lat.to(h.dtype), latent.to(h.dtype)

    def mla_latent_out(self, ctx: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
        """Attention over the latents ``ctx`` [B, S, H, DL] (its first rkv
        columns are read) -> each head's v through W_uv, zero-padded to the
        qk head dim: [B, S, H * dq] for ``wo``."""
        m = cfg.mla
        B, S, H, _ = ctx.shape
        dn, dv, rkv = m.qk_nope_head_dim, m.v_head_dim, m.kv_lora_rank
        w = _dense_weight(self.wukv)
        ct = torch.promote_types(ctx.dtype, w.dtype)
        w_uv = w.to(ct).view(rkv, H, dn + dv)[:, :, dn:]
        o = torch.einsum("bshr,rhv->bshv", ctx[..., :rkv].to(ct), w_uv)
        o = torch.cat([o, o.new_zeros(B, S, H, m.qk_head_dim - dv)], dim=-1)
        return o.reshape(B, S, H * m.qk_head_dim).to(ctx.dtype)

    def col(self, h: torch.Tensor, w, plain: bool = False) -> torch.Tensor:
        return _col(h, w, plain, self.tp)

    def enter(self, x: torch.Tensor, axes: tuple[str, ...] = (AXES.tp,)) -> torch.Tensor:
        """A replicated tensor (or weight) entering this rank's share of a
        sharded computation: itself, with its training gradient summed
        over ``axes`` (``collectives.replicate``), since each rank
        differentiates only its share."""
        return replicate(x, self.mesh, axes)

    def row(self, h: torch.Tensor, w, plain: bool = False) -> torch.Tensor:
        """A row-parallel product: ``_mm`` over this rank's input rows, the
        partial sums all-reduced over ``tp``."""
        return _reduce(_mm(h, w, plain), self.mesh, AXES.tp)

    # -- MLPs ---------------------------------------------------------------
    def mlp(self, h: torch.Tensor, plain: bool = False) -> torch.Tensor:
        h = self.enter(h)
        gate = F.silu(self.col(h, self.wg, plain)) * self.col(h, self.wu, plain)
        return self.row(gate, self.wd, plain)

    def moe_mlp(
        self, h: torch.Tensor, cfg: ModelConfig, plain: bool = False,
        with_aux: bool = False, data_axes: tuple[str, ...] = (),
    ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """JAX's ``_moe_mlp``: f32 router logits, softmax or sigmoid scores,
        ``router_bias`` added for selection only, group-limited top-k
        (groups ranked by their top-2 sum under sigmoid, their max under
        softmax), combine weights renormalized and scaled per the config,
        every expert over every token weighted by its combine weight and
        summed in expert order (the all-experts form the engines serve
        with) or, from ``grouped_dispatch_min_tokens`` tokens on, the
        grouped dispatch; plus the shared experts. Returns (output, Switch
        balance loss or None). bf16/f32 experts run as batched products
        over the stacked weights; quantized ones, in the all-experts form,
        one 2-D slice a call through ``_mm``. No step here reads the device
        from the host, so the form runs inside a captured graph.

        With a mesh, this rank's E/ep experts (of fe/tp columns) add their
        terms, and the sum is all-reduced over ``ep`` and, with the shared
        experts' partial sums, over ``tp``: the same sum in another
        order. In training the tokens and combine weights enter the experts
        through ``enter`` over ep and tp (each rank differentiates its
        experts' terms only).

        ``data_axes`` (training at dp or sp > 1 and pp = 1: one batch spread
        over those ranks, ``h`` this rank's P(dp, sp) slice of it) makes
        the layer the whole batch's function, as JAX's under GSPMD: the
        grouped dispatch is chosen, and its capacity and queue slots
        counted, over the whole batch; and the balance loss is this rank's
        share of the whole batch's statistic, E · Σ_e f_e · P_e with f_e
        counted over every rank's tokens and P_e's sum taken over this
        rank's, so that the shares add up over the axes to JAX's value."""
        m = cfg.moe
        E, k = m.num_experts, m.num_experts_per_token
        B, S, d = h.shape
        logits = h.float() @ self.router                              # [B, S, E]
        if m.scoring_func == "sigmoid":
            probs = torch.sigmoid(logits)
        else:
            probs = torch.softmax(logits, dim=-1)
        select = probs
        if hasattr(self, "router_bias"):
            select = select + self.router_bias
        if m.n_group > 1:
            g = select.view(B, S, m.n_group, E // m.n_group)
            if m.scoring_func == "sigmoid":
                group_score = g.topk(2, dim=-1).values.sum(-1)
            else:
                group_score = g.amax(-1)
            keep_idx = group_score.topk(m.topk_group, dim=-1).indices
            keep = torch.zeros_like(group_score).scatter_(-1, keep_idx, 1.0)
            select = torch.where(keep[..., None] > 0, g, -torch.inf).view(B, S, E)
        idx = select.topk(k, dim=-1).indices                          # [B, S, k]
        vals = probs.gather(-1, idx)
        if m.norm_topk_prob:
            vals = vals / (vals.sum(-1, keepdim=True) + 1e-20)
        if m.routed_scaling_factor != 1.0:
            vals = vals * m.routed_scaling_factor
        axes = tuple(a for a in data_axes if self.mesh is not None and self.mesh.shape[a] > 1)
        T = B * S
        n = T * math.prod(self.mesh.shape[a] for a in axes)          # the whole batch's
        aux = None
        if with_aux:
            sel = torch.zeros_like(probs).scatter_(-1, idx, 1.0)
            if axes:
                f_e = reduce_sum(sel.sum(dim=(0, 1)), self.mesh, axes) / (k * n)
                aux = E * (f_e * (probs.sum(dim=(0, 1)) / n)).sum()
            else:
                f_e = (sel / k).mean(dim=(0, 1))
                aux = E * (f_e * probs.mean(dim=(0, 1))).sum()
        x = self.enter(h, (AXES.ep, AXES.tp)).reshape(T, d)
        vals = self.enter(vals, (AXES.ep, AXES.tp))
        El, e0 = self.eg.shape[0], self.expert0
        if 0 < m.grouped_dispatch_min_tokens <= n:
            out = self._moe_grouped_dispatch(x, cfg, vals.reshape(T, k), idx, axes)
        elif isinstance(self.eg, QuantizedBase):
            # JAX's scan: one expert at a time into an h.dtype accumulator.
            combine = torch.zeros_like(probs).scatter_(-1, idx, vals)
            combine = combine.view(T, E).T.to(h.dtype)                # [E, T]
            out = torch.zeros_like(x)
            for e in range(El):
                y = _mm(F.silu(self.col(x, _expert(self.eg, e), plain))
                        * self.col(x, _expert(self.eu, e), plain),
                        _expert(self.ed, e), plain)
                out = out + combine[e0 + e, :, None] * y
        else:
            xe = x.expand(El, *x.shape)
            y = torch.bmm(F.silu(torch.bmm(xe, self.eg)) * torch.bmm(xe, self.eu), self.ed)
            # The same sum in k adds, not E: an expert a token did not
            # select adds a zero, so the scan's sum is the k selected terms
            # in ascending expert order, rounded to h.dtype after each add.
            # Another rank's expert adds a zero here too.
            order, perm = idx.reshape(T, k).sort(-1)
            c = vals.reshape(T, k).gather(-1, perm).to(h.dtype)
            if El < E:
                order = order - e0
                c = torch.where((order >= 0) & (order < El), c, 0.0)
                order = order.clamp(0, El - 1)
            terms = c[..., None] * y.transpose(0, 1).gather(1, order[..., None].expand(T, k, d))
            out = terms[:, 0]
            for j in range(1, k):
                out = out + terms[:, j]
        out = _reduce(out.view(B, S, d), self.mesh, AXES.ep)
        if m.num_shared_experts:
            hs = self.enter(h)
            out = out + _mm(
                F.silu(self.col(hs, self.sg, plain)) * self.col(hs, self.su, plain), self.sd,
                plain,
            )
        return _reduce(out, self.mesh, AXES.tp), aux

    def _moe_grouped_dispatch(
        self, x: torch.Tensor, cfg: ModelConfig, vals: torch.Tensor, idx: torch.Tensor,
        data_axes: tuple[str, ...] = (),
    ) -> torch.Tensor:
        """JAX's ``_moe_grouped_dispatch`` over tokens ``x`` [T, d] with
        combine weights ``vals`` [T, k] and expert ids ``idx`` [B, S, k]
        (T = B·S): each (token,
        choice) assignment takes the next slot of its expert's queue of C =
        max(1, min(T, ceil(T·k/E · capacity_factor))) slots, counted in
        token-major order; the experts run as three batched products over
        [E, C, d]; each assignment's output comes back weighted by its
        combine weight, and a token's k terms are summed in choice order.
        An assignment past its expert's capacity is dropped: it is copied
        to a sentinel row E·C that is cut off, and adds nothing. Every step
        is differentiable (training runs it), and none reads the device
        from the host.

        At a mesh every rank fills the buckets of all E experts from its
        replicated tokens and runs its own E/ep (of fe/tp columns); an
        assignment to another rank's expert adds a zero here, and the
        caller sums over ep and then tp: JAX's function under GSPMD. With
        ``data_axes`` (``moe_mlp``) the tokens are this rank's P(dp, sp)
        slice of the batch: the expert ids are all-gathered over those axes
        so that capacity and queue slots are the whole batch's, and this
        rank fills the buckets with its own tokens' assignments only."""
        m = cfg.moe
        E, k = m.num_experts, m.num_experts_per_token
        T, d = x.shape
        flat_e = idx.reshape(T * k)
        flat_w = vals.reshape(T * k).to(x.dtype)
        every = idx
        for a, dim in ((AXES.sp, 1), (AXES.dp, 0)):
            if a in data_axes:
                every = all_gather(every, self.mesh, a, dim)
        n = every.shape[0] * every.shape[1]
        C = max(1, min(n, math.ceil(n * k / E * m.capacity_factor)))
        # [n*k, E] by comparison: F.one_hot checks its range on the host.
        onehot = (every.reshape(n * k)[:, None] == torch.arange(E, device=x.device)).long()
        pos = ((onehot.cumsum(0) - 1) * onehot).sum(-1)                 # slot in queue
        if data_axes:
            B, S = idx.shape[:2]
            r0 = self.mesh.coords[AXES.dp] * B if AXES.dp in data_axes else 0
            c0 = self.mesh.coords[AXES.sp] * S if AXES.sp in data_axes else 0
            pos = pos.view(every.shape)[r0:r0 + B, c0:c0 + S].reshape(T * k)
        keep = pos < C
        dest = torch.where(keep, flat_e * C + pos, E * C)
        src = x.repeat_interleave(k, dim=0)                             # token-major
        disp = x.new_zeros(E * C + 1, d).index_copy(0, dest, src)[: E * C].view(E, C, d)
        El, e0 = self.eg.shape[0], self.expert0
        mine = disp[e0:e0 + El]
        up = F.silu(_ein(mine, self.eg)) * _ein(mine, self.eu)
        y = _ein(up, self.ed).reshape(El * C, d)
        row = dest - e0 * C
        own = keep & (row >= 0) & (row < El * C)
        per_pair = torch.where(
            own[:, None], y[torch.where(own, row, 0)], x.new_zeros(())
        ) * flat_w[:, None]
        return per_pair.view(T, k, d).sum(1)


class Llama(nn.Module):
    """The decoder. ``seed`` fills the weights with the fan-in-scaled normal
    init of ``opsagent_tpu``'s ``init_params`` (norms at 1, biases and the
    router's selection bias at 0), drawn on ``device`` from a
    ``torch.Generator`` one parameter at a time, so an 8B or a 16B MoE
    model is built on the card in seconds without a host copy;
    ``seed=None`` leaves them uninitialized for ``load_state_dict``.
    ``quantize`` ("int8" or "int4") builds the projections, the experts and
    the lm_head as quantized weights, which a seed fills directly in
    quantized form (``init_random``). With tied embeddings there is no
    ``lm_head``: the head is ``x @ embed.T``, full precision under
    ``quantize`` too. Layers ``moe_layer_start`` and on are MoE layers
    under ``cfg.moe``.

    ``mesh`` (``parallel.mesh``, more than one rank): this rank's shard
    (the module docstring). A seed draws each full parameter from the same
    generator as the one-rank model, one at a time, and keeps this rank's
    slice, so the shards are slices of the one-rank model;
    ``load_full_state_dict`` slices a full state dict the same way.

    At pp > 1 the model is one pipeline stage, which training runs
    (``parallel.pipeline``): it holds the layers ``stage_layers`` gives it,
    keyed by their global index (``layers`` is then a ``ModuleDict``, so
    the state dict names them as the one-rank model does), beside the
    embedding, final norm and head, which every stage holds whole as in
    JAX. A stage holds full-precision weights only."""

    def __init__(
        self, cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16,
        device: str | torch.device | None = None, seed: int | None = 0,
        quantize: str = "", mesh: Mesh | None = None,
    ):
        super().__init__()
        _check_mla(cfg)
        if quantize not in QUANTIZE_MODES:
            raise ValueError(
                f"quantize={quantize!r}: supported values are 'int8' "
                "(per-channel) and 'int4' (group-wise)"
            )
        device = resolve_device(device)
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        _check_shards(cfg, self.mesh)
        self.tp = 1 if self.mesh is None else self.mesh.shape[AXES.tp]
        self.cfg, self.dtype, self.quantize = cfg, dtype, quantize
        self.layer_ids = stage_layers(cfg, self.mesh)
        if quantize and len(self.layer_ids) < cfg.num_layers:
            raise ValueError("a pipeline stage (pp > 1) trains: it holds full-precision "
                             f"weights, not {quantize}")
        d, v = cfg.hidden_size, cfg.vocab_size // self.tp
        self.embed = nn.Parameter(
            torch.empty(v, d, dtype=dtype, device=device), requires_grad=False
        )
        dense, _ = _layer_split(cfg)
        made = [DecoderLayer(cfg, dtype, device, quantize, moe=i >= dense, mesh=self.mesh)
                for i in self.layer_ids]
        if len(made) == cfg.num_layers:
            # Positional: callers index the whole stack as model.layers[i].
            self.layers = nn.ModuleList(made)
        else:
            self.layers = nn.ModuleDict({str(i): m for i, m in zip(self.layer_ids, made)})
        self.final_norm = _vector(d, dtype, device)
        if not cfg.tie_embeddings:
            self.lm_head = _linear(d, v, dtype, device, quantize)
        self._specs = state_specs(cfg, quantize) if self.mesh is not None else {}
        # int4 scale keys whose groups shard with their rows (a loaded
        # state's; a seed draws one whole-axis group).
        self._split_scales: set[str] = set()
        if seed is not None:
            self.init_random(seed)

    def stack(self) -> list[tuple[int, DecoderLayer]]:
        """(global index, layer) of each layer this model holds, in order."""
        return list(zip(self.layer_ids, self.layers.children()))

    def _local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a full tensor drawn for ``name``."""
        if self.mesh is None:
            return full
        return shard_tensor(full, self._specs[name], self.mesh)

    def _shape(self, name: str, shape) -> tuple[int, ...]:
        """The full shape of the entry ``name`` whose shard has ``shape``."""
        return _full_shape(shape, self._specs.get(name, ()), self.mesh)

    def load_full_state_dict(self, state: dict[str, torch.Tensor]) -> None:
        """Load a full (one-rank) state dict: each entry sliced to this
        rank's shard (``local_state``), e.g. ``models.convert``'s
        ``params_from_jax`` of a JAX tree."""
        self._split_scales = split_int4_scales(state, self.cfg, self.mesh, self.quantize)
        self.load_state_dict(local_state(state, self.cfg, self.mesh, self.quantize))

    def full_tensor(self, key: str, t: torch.Tensor) -> torch.Tensor:
        """The full (one-rank) tensor of the state entry ``key`` from this
        rank's shard ``t``: all-gathered over each axis its spec shards, in
        order (``local_state`` inverted). At a mesh every rank calls it, for
        the same keys in one order; at one rank it returns ``t``."""
        if self.mesh is None:
            return t
        spec = self._specs[key]
        if key in self._split_scales:
            axis = _row_sharded(self._specs[key[: -len("scale")] + "q"])
            spec = (*spec[:-3], axis, *spec[-2:])
        for d, axis in enumerate(spec):
            if axis is not None and self.mesh.shape[axis] > 1:
                t = all_gather(t.contiguous(), self.mesh, axis, dim=d)
        return t

    def _fan_in(self, name: str, shape) -> int:
        """The fan-in of a weight's init: its contraction dim ([in, out]
        weights, stacked experts too), the embedding's row width, and for
        MLA's padded ``wo`` the real rows, H * v_head_dim, as JAX's init."""
        leaf = name.rsplit(".", 1)[-1]
        if name == "embed":
            return shape[1]
        if leaf == "wo" and self.cfg.mla is not None:
            return self.cfg.num_heads * self.cfg.mla.v_head_dim
        return shape[-2]

    @torch.no_grad()
    def init_random(self, seed: int) -> None:
        """Norms (and Qwen3's q/k norms) at 1, q/k/v biases and the router's
        selection bias at 0; the embedding, the router and plain weights
        normal with std fan_in^-1/2; quantized weights as
        ``init_params_random_quantized`` makes them: uniform codes in
        [-127, 127] (int4: [-7, 7], packed, one whole-axis group) and one
        scale per tensor, chosen so the dequantized std matches the fan-in
        scaling. No full-precision copy of a quantized weight is ever
        built."""
        gen = torch.Generator(device=self.embed.device).manual_seed(seed)
        for name, p, local_shape in self._draw_order():
            leaf = name.rsplit(".", 1)[-1]
            if leaf.endswith("norm") or leaf in ("qn", "kn"):
                if p is not None:
                    p.fill_(1.0)
                continue
            if leaf in ("bq", "bk", "bv", "router_bias"):
                if p is not None:
                    p.zero_()
                continue
            shape = self._shape(name, local_shape)
            full = torch.randn(shape, generator=gen, device=self.embed.device,
                               dtype=torch.float32)
            if p is not None:
                p.copy_(self._local(name, full.mul_(self._fan_in(name, shape) ** -0.5)))
            del full
        for name, w in self.named_modules():
            if not isinstance(w, QuantizedBase):
                continue
            shape = self._shape(f"{name}.q", w.shape)
            top = 7 if isinstance(w, QuantizedLinear4) else 127
            # The logical codes' slice, then packing: a shard's packed rows
            # are the packed rows of its logical rows.
            codes = self._local(f"{name}.q", torch.randint(
                -top, top + 1, tuple(shape), generator=gen, device=w.q.device,
                dtype=torch.int8,
            ))
            w.q.copy_(pack_int4(codes) if top == 7 else codes)
            # std(U[-top, top]) = top / sqrt(3), matched to fan_in^-1/2.
            w.scale.fill_(self._fan_in(name, shape) ** -0.5 * 3.0 ** 0.5 / top)
            del codes

    def _draw_order(self) -> list[tuple[str, nn.Parameter | None, tuple[int, ...]]]:
        """(name, parameter, local shape) of every parameter of the one-rank
        model, in its order: a pipeline stage draws the layers other stages
        hold too (parameter None) so that the generator reaches its own at
        the one-rank model's place."""
        if len(self.layer_ids) == self.cfg.num_layers:
            return [(n, p, tuple(p.shape)) for n, p in self.named_parameters()]
        held = dict(self.named_parameters())
        dense, _ = _layer_split(self.cfg)
        meta = {moe: DecoderLayer(self.cfg, self.dtype, torch.device("meta"), moe=moe,
                                  mesh=self.mesh)
                for moe in ((False, True) if self.cfg.moe is not None else (False,))}
        # The model's own parameters come first, then its layers'.
        out = [(n, p, tuple(p.shape)) for n, p in self.named_parameters(recurse=False)]
        for i in range(self.cfg.num_layers):
            for n, p in meta[i >= dense].named_parameters():
                name = f"layers.{i}.{n}"
                out.append((name, held.get(name), tuple(p.shape)))
        return out

    def make_cache(
        self, num_pages: int, page_size: int, kv_quantize: str = "",
    ) -> PagedKVCache:
        return PagedKVCache(
            self.cfg, num_pages, page_size, self.dtype, self.embed.device,
            kv_quantize, tp=self.tp,
        )

    def _rope(self, positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return rope_table(
            positions, self.cfg.rope_dim_, self.cfg.rope_theta, self.cfg.rope_scaling
        )

    def _layer(
        self, layer: DecoderLayer, li: int, x: torch.Tensor, attn_fn, plain: bool,
        with_aux: bool, data_axes: tuple[str, ...] = (),
    ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """One layer's body: (hidden states after it, its MoE balance loss
        or None)."""
        eps = self.cfg.rms_norm_eps
        h = rms_norm(x, layer.attn_norm, eps)
        x = x + layer.row(attn_fn(h, layer, li), layer.wo, plain)
        h = rms_norm(x, layer.mlp_norm, eps)
        if layer.moe:
            y, aux = layer.moe_mlp(h, self.cfg, plain, with_aux, data_axes)
        else:
            y, aux = layer.mlp(h, plain), None
        return x + y, aux

    def _run_stack(
        self, x: torch.Tensor, attn_fn, plain: bool, with_aux: bool = False,
        remat: bool = False, layers: list[tuple[int, DecoderLayer]] | None = None,
        data_axes: tuple[str, ...] = (),
    ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """The layers in order (``layers``, default all this model holds),
        dense then MoE: (hidden states, summed MoE balance loss, or None
        without ``with_aux``). ``remat`` runs each layer under activation
        checkpointing (JAX's ``jax.checkpoint`` of the scanned body): the
        backward recomputes the layer's activations instead of keeping
        them."""
        aux = None
        for li, layer in self.stack() if layers is None else layers:
            if remat:
                x, layer_aux = checkpoint(
                    self._layer, layer, li, x, attn_fn, plain, with_aux, data_axes,
                    use_reentrant=False,
                )
            else:
                x, layer_aux = self._layer(layer, li, x, attn_fn, plain, with_aux, data_axes)
            if layer_aux is not None:
                aux = layer_aux if aux is None else aux + layer_aux
        if with_aux and aux is None:
            aux = x.new_zeros((), dtype=torch.float32)
        return x, aux

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """The embedding rows of ``tokens`` in the model's dtype. At tp > 1
        the vocab-parallel lookup: ids outside this rank's rows give zeros,
        and the ranks' rows are all-reduced (one of them is not zero)."""
        if self.tp == 1:
            return self.embed[tokens].to(self.dtype)
        rows = self.embed.shape[0]
        local = tokens - self.mesh.coords[AXES.tp] * rows
        mine = (local >= 0) & (local < rows)
        x = torch.where(mine[..., None], self.embed[local.clamp(0, rows - 1)], 0.0)
        return _reduce(x.to(self.dtype), self.mesh, AXES.tp)

    def _lm_head(self, x: torch.Tensor, plain: bool) -> torch.Tensor:
        """f32 logits over the whole vocab; at tp > 1 each rank's vocab
        columns all-gathered over ``tp``."""
        x = rms_norm(x, self.final_norm, self.cfg.rms_norm_eps)
        if self.tp > 1:
            x = replicate(x, self.mesh, AXES.tp)
        if self.cfg.tie_embeddings:
            logits = (x @ self.embed.T.to(x.dtype)).float()
        else:
            logits = _col(x, self.lm_head, plain, self.tp).float()
        if self.tp == 1:
            return logits
        return gather(logits, self.mesh, AXES.tp, dim=-1)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """The final norm and the head over hidden states [..., d]: f32
        logits [..., V] (the training loss's)."""
        return self._lm_head(x, True)

    def full_attention(self, B: int, S: int, start: int = 0, attention=None):
        """The ``attn_fn`` of an all-positions forward over rows of S
        positions from global position ``start``: q/k/v with RoPE there
        (MLA materialized), then ``attention(q, k, v)`` (default plain
        causal attention over these positions; the trainer passes ring or
        gathered attention over sp)."""
        pos = start + torch.arange(S, device=self.embed.device)[None, :].expand(B, S)
        cos, sin = self._rope(pos)
        attend = causal_prefill_attention if attention is None else attention

        def attn_fn(h, layer, li):
            q, k, v = layer.qkv_rope(h, self.cfg, cos, sin, plain=True)
            return attend(q, k, v).reshape(B, S, -1)

        return attn_fn

    def hidden(
        self, x: torch.Tensor, attn_fn, layers: list[tuple[int, DecoderLayer]] | None = None,
        remat: bool = False, data_axes: tuple[str, ...] = (),
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Hidden states ``x`` [B, S, d] through ``layers`` (default all
        this model holds) in plain PyTorch: (hidden states, summed MoE
        balance loss, 0 without MoE layers), as training runs them."""
        return self._run_stack(x, attn_fn, True, True, remat, layers, data_axes)

    def forward_full(
        self, tokens: torch.Tensor, return_aux: bool = False, remat: bool = False,
    ):
        """All-positions logits [B, S, V] f32: plain causal attention over
        the fresh sequence, no cache (MLA materialized). ``return_aux``
        also returns the summed MoE balance loss (0 for dense models);
        ``remat`` checkpoints each layer (the training step's option)."""
        B, S = tokens.shape
        attn_fn = self.full_attention(B, S)
        x, aux = self._run_stack(self._embed(tokens), attn_fn, True, return_aux, remat)
        logits = self._lm_head(x, True)
        return (logits, aux) if return_aux else logits

    def prefill(
        self,
        tokens: torch.Tensor,       # [B, S] int, right-padded
        lengths: torch.Tensor,      # [B] int32 valid lengths
        cache: PagedKVCache,
        page_table: torch.Tensor,   # [B, MaxP] int32
        plain: bool = False,
        prefill_attn=None,
    ) -> torch.Tensor:
        """JAX's ``prefill``: a fresh prompt's full-sequence forward that
        attends causally over the fresh K/V (``causal_prefill_attention``,
        or ``prefill_attn(q, k, v, lengths)``: the engine passes ring
        attention over ``sp``, ``parallel.ring.make_ring_attention``),
        writes each row's valid K/V at position 0 on (MLA: attends in the
        materialized form and writes only the latent to a latent cache), and
        returns the logits of each row's last valid position [B, V] f32.
        Without ``prefill_attn`` the engine does not call it: every
        split-lane chunk, a fresh prompt's too, runs ``prefill_with_prefix``
        with ``start`` 0, through the ragged kernels; and the causal
        attention is plain PyTorch, so on a CUDA tensor it raises unless
        ``plain`` asks for that reference. With ``prefill_attn`` (the
        engine's fresh chunks at sp > 1) the projections run as the other
        entry points' do."""
        if tokens.is_cuda and not plain and prefill_attn is None:
            raise ValueError(
                "Llama.prefill attends in plain PyTorch; on the card the engine "
                "prefills through prefill_with_prefix (start 0) and its kernels "
                "(pass plain=True for the reference)"
            )
        B, S = tokens.shape
        start = torch.zeros((B,), dtype=torch.int32, device=tokens.device)
        cos, sin = self._rope(torch.arange(S, device=tokens.device)[None, :].expand(B, S))
        flat = flat_slot_indices(
            page_table, start, S, cache.page_size, cache.num_pages, valid_len=lengths,
        ).reshape(-1)

        def attn_fn(h, layer, li):
            if cache.latent:
                q, k, v, latent = layer.qkv_mla(h, self.cfg, cos, sin, plain,
                                                with_latent=True)
                cache.write(li, latent, None, flat)
            else:
                q, k, v = layer.qkv_rope(h, self.cfg, cos, sin, plain)
                cache.write(li, k, v, flat)
            if prefill_attn is not None:
                return prefill_attn(q, k, v, lengths).reshape(B, S, -1)
            return causal_prefill_attention(q, k, v).reshape(B, S, -1)

        x, _ = self._run_stack(self._embed(tokens), attn_fn, plain)
        last = (lengths.long() - 1).clamp(0, S - 1)
        return self._lm_head(x[torch.arange(B, device=x.device), last], plain)

    def _shard_contract(self, backend: str) -> dict:
        return dict(tp=self.tp, num_heads=self.cfg.num_heads,
                    num_kv_heads=self.cfg.num_kv_heads, backend=backend)

    def _ragged(self, attention, backend: str):
        """The ragged attention of this rank: ``attention``, or at tp > 1 the
        tensor-parallel wrapper of the backend's kernel over this rank's
        heads (not the latent cache's, whose one kv head every rank
        holds)."""
        if self.tp == 1 or _latent_cache(self.cfg):
            return attention
        return partial(paged_ragged_attention_tp, **self._shard_contract(backend))

    def _paged_hidden(
        self, tokens: torch.Tensor, start: torch.Tensor, q_lens: torch.Tensor,
        cache: PagedKVCache, page_table: torch.Tensor, plain: bool, attention,
    ) -> torch.Tensor:
        """Ragged rows over the paged cache: each row's valid K/V (or latent)
        written at ``start``, ``attention(q, k_pages, v_pages, page_table,
        start, q_lens, plain=...)`` over the pages; the final hidden states
        [B, S, d] before the last norm."""
        B, S = tokens.shape
        pos = start.long()[:, None] + torch.arange(S, device=tokens.device)[None, :]
        cos, sin = self._rope(pos)
        flat = flat_slot_indices(
            page_table, start, S, cache.page_size, cache.num_pages,
            valid_len=q_lens,
        ).reshape(-1)

        def attn_fn(h, layer, li):
            if cache.latent:
                q_lat, latent = layer.mla_latent_parts(h, self.cfg, cos, sin, plain)
                cache.write(li, latent, None, flat)
                # The latent is both keys and values.
                ctx = attention(
                    q_lat, cache.k[li], cache.k[li], page_table, start, q_lens,
                    plain=plain,
                )
                return layer.mla_latent_out(ctx, self.cfg)
            q, k, v = layer.qkv_rope(h, self.cfg, cos, sin, plain)
            cache.write(li, k, v, flat)
            # cache.k[li] is a view: the attention reads the rows just written.
            attn = attention(
                q, cache.k[li], cache.v[li], page_table, start, q_lens,
                plain=plain,
            )
            return attn.reshape(B, S, -1)

        x, _ = self._run_stack(self._embed(tokens), attn_fn, plain)
        return x

    def _paged_forward(
        self, tokens: torch.Tensor, start: torch.Tensor, q_lens: torch.Tensor,
        cache: PagedKVCache, page_table: torch.Tensor, plain: bool, attention,
    ) -> torch.Tensor:
        """``_paged_hidden``, then the logits of each row's last valid
        position [B, V] f32."""
        x = self._paged_hidden(tokens, start, q_lens, cache, page_table, plain, attention)
        S = tokens.shape[1]
        last = (q_lens.long() - 1).clamp(0, S - 1)
        return self._lm_head(x[torch.arange(x.shape[0], device=x.device), last], plain)

    def verify_step(
        self,
        tokens: torch.Tensor,       # [B, S] int draft-chunk inputs
        start: torch.Tensor,        # [B] int32 write offsets
        valid: torch.Tensor,        # [B] int32 valid chunk lengths
        cache: PagedKVCache,
        page_table: torch.Tensor,   # [B, MaxP] int32
        plain: bool = False,
        backend: str = "dma",
    ) -> torch.Tensor:
        """JAX's ``verify_step``, the speculative verify forward: each
        row's S-token draft chunk in one pass over the paged cache, its
        valid K/V (or latent) written at ``start``, attention through the
        ``backend``'s ragged kernel as ``prefill_with_prefix``'s. Returns
        the logits of every chunk position [B, S, V] f32: position j's
        argmax is the model's greedy token after the chunk's first j + 1
        inputs. Rejected positions' K/V is overwritten later, since the
        write offset advances by the accepted count only; positions past
        ``valid`` write nothing and their logits are not read."""
        attention = self._ragged(partial(paged_prefix_attention, backend=backend), backend)
        x = self._paged_hidden(tokens, start, valid, cache, page_table, plain, attention)
        return self._lm_head(x, plain)

    def prefill_with_prefix(
        self,
        tokens: torch.Tensor,       # [B, S] int tail tokens, right-padded
        start: torch.Tensor,        # [B] int32 cached-prefix lengths
        lengths: torch.Tensor,      # [B] int32 valid tail lengths
        cache: PagedKVCache,
        page_table: torch.Tensor,   # [B, MaxP] int32 prefix pages + tail pages
        plain: bool = False,
        backend: str = "dma",
    ) -> torch.Tensor:
        """JAX's ``prefill_with_prefix``, the split prefill lane's program:
        forwards only each row's tail, writes its K/V (or latent) at
        ``start`` and attends over the cached prefix plus the tail through
        ``paged_prefix_attention`` (the ``backend``'s ragged kernel on the
        card). Returns the last valid tail position's logits [B, V] f32;
        rows with length 0 write nothing."""
        attention = self._ragged(partial(paged_prefix_attention, backend=backend), backend)
        return self._paged_forward(tokens, start, lengths, cache, page_table, plain, attention)

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
        up to S) together: writes each row's valid K/V (or latent) at
        ``start`` and returns the logits of its last valid position [B, V]
        f32. Rows with q_len 0 write nothing; their logits are discarded by
        the caller. ``backend`` picks the paged-attention kernels ("dma" or
        "grid"); ``plain`` runs attention and the quantized matmuls through
        their plain PyTorch versions."""
        return self._paged_forward(tokens, start, q_lens, cache, page_table, plain,
                                   self._ragged(PAGED_BACKENDS[backend][0], backend))

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
        """One token per sequence: writes its K/V (or latent) at
        ``lengths`` and returns the next-token logits [B, V] f32
        (``backend`` and ``plain`` as in ``mixed_step``)."""
        decode_attention = PAGED_BACKENDS[backend][1]
        if self.tp > 1 and not cache.latent:
            decode_attention = partial(paged_decode_attention_tp, **self._shard_contract(backend))
        B = tokens.shape[0]
        cos, sin = self._rope(lengths.long()[:, None])
        valid = active.to(torch.int32)
        flat = flat_slot_indices(
            page_table, lengths, 1, cache.page_size, cache.num_pages,
            valid_len=valid,
        ).reshape(-1)
        seen = (lengths + valid).to(torch.int32)

        def attn_fn(h, layer, li):
            if cache.latent:
                q_lat, latent = layer.mla_latent_parts(h, self.cfg, cos, sin, plain)
                cache.write(li, latent, None, flat)
                ctx = decode_attention(
                    q_lat[:, 0], cache.k[li], cache.k[li], page_table, seen,
                    plain=plain,
                )
                return layer.mla_latent_out(ctx[:, None], self.cfg)
            q, k, v = layer.qkv_rope(h, self.cfg, cos, sin, plain)
            cache.write(li, k, v, flat)
            # cache.k[li] is a view: the attention reads the row just written.
            attn = decode_attention(
                q[:, 0], cache.k[li], cache.v[li], page_table, seen,
                plain=plain,
            )
            return attn.reshape(B, 1, -1)

        x, _ = self._run_stack(self._embed(tokens[:, None]), attn_fn, plain)
        return self._lm_head(x[:, 0], plain)
