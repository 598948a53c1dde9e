"""HF safetensors checkpoints -> a ``Llama`` state dict (the port's
counterpart of ``opsagent_tpu/models/loader.py``).

The HF llama-family names (``model.layers.N.self_attn.q_proj.weight``...)
map onto the port's module names; matrices are transposed from HF's
``[out, in]`` to the ``[in, out]`` the port keeps. Single-file and
index-sharded (``model.safetensors.index.json``) checkpoints load alike.
Qwen2's q/k/v biases and Qwen3's q/k norms load when the configuration
has them; a missing ``lm_head.weight`` is allowed only with tied
embeddings, and tied embeddings ignore one that is present. MoE layers use
the DeepSeek names (``mlp.gate.weight`` router, kept f32, with
``e_score_correction_bias`` for a sigmoid router;
``mlp.experts.{e}.{gate,up,down}_proj`` stacked ``[E, in, out]``;
``mlp.shared_experts.*``); MLA layers (DeepSeek-V2/V3) as JAX's
``_load_mla_attn_block`` lays them out: ``kv_a_proj_with_mqa`` split into
``wdkv`` and ``wkr``, the rope columns of q and ``wkr`` permuted from HF's
interleaved pairs to the half-split order ``apply_rope`` uses, and
``o_proj`` expanded to per-head rows over the padded head dim (pad rows 0).

The format is read and written here, without the ``safetensors`` package
(the machine beside the card has none): an 8-byte little-endian header
length, a JSON header of ``{name: {dtype, shape, data_offsets}}``, then the
raw little-endian tensor bytes, mapped with ``numpy.memmap``. F32, F16 and
BF16 are read; BF16 as uint16 viewed as ``torch.bfloat16``.
``save_checkpoint`` writes a model back out under the names JAX's
``save_checkpoint`` writes (the inverse of the load, the MLA split
included), so a trained or fine-tuned port model serves from
``--checkpoint`` and loads in the JAX package.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..device import resolve_device
from .config import ModelConfig
from .quant import quantize_params

# safetensors dtype -> (numpy dtype of the raw bytes, torch dtype).
_DTYPES = {
    "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16),
    "BF16": (np.uint16, torch.bfloat16),
}
_NAMES = {dtype: (name, np_dtype) for name, (np_dtype, dtype) in _DTYPES.items()}

# Port name -> HF name, per layer ({} = layer index).
_LAYER_NAMES = {
    "attn_norm": "model.layers.{}.input_layernorm.weight",
    "wq": "model.layers.{}.self_attn.q_proj.weight",
    "wk": "model.layers.{}.self_attn.k_proj.weight",
    "wv": "model.layers.{}.self_attn.v_proj.weight",
    "wo": "model.layers.{}.self_attn.o_proj.weight",
    "mlp_norm": "model.layers.{}.post_attention_layernorm.weight",
    "wg": "model.layers.{}.mlp.gate_proj.weight",
    "wu": "model.layers.{}.mlp.up_proj.weight",
    "wd": "model.layers.{}.mlp.down_proj.weight",
}
_BIAS_NAMES = {
    "bq": "model.layers.{}.self_attn.q_proj.bias",
    "bk": "model.layers.{}.self_attn.k_proj.bias",
    "bv": "model.layers.{}.self_attn.v_proj.bias",
}
_QK_NORM_NAMES = {
    "qn": "model.layers.{}.self_attn.q_norm.weight",
    "kn": "model.layers.{}.self_attn.k_norm.weight",
}


_MLA_NAMES = {
    "attn_norm": "model.layers.{}.input_layernorm.weight",
    "kv_norm": "model.layers.{}.self_attn.kv_a_layernorm.weight",
    "wukv": "model.layers.{}.self_attn.kv_b_proj.weight",
    "mlp_norm": "model.layers.{}.post_attention_layernorm.weight",
}
_MLA_LOW_RANK_Q_NAMES = {
    "wdq": "model.layers.{}.self_attn.q_a_proj.weight",
    "q_norm": "model.layers.{}.self_attn.q_a_layernorm.weight",
}
_DENSE_MLP_NAMES = {key: _LAYER_NAMES[key] for key in ("wg", "wu", "wd")}
_SHARED_NAMES = {
    "sg": "model.layers.{}.mlp.shared_experts.gate_proj.weight",
    "su": "model.layers.{}.mlp.shared_experts.up_proj.weight",
    "sd": "model.layers.{}.mlp.shared_experts.down_proj.weight",
}
_EXPERT_NAMES = {
    "eg": "model.layers.{}.mlp.experts.{}.gate_proj.weight",
    "eu": "model.layers.{}.mlp.experts.{}.up_proj.weight",
    "ed": "model.layers.{}.mlp.experts.{}.down_proj.weight",
}


class CheckpointError(Exception):
    pass


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file, as CPU tensors over a
    copy-on-write memory map of the file (nothing is read until used)."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    raw = np.memmap(path, dtype=np.uint8, mode="c")
    base = 8 + n
    out: dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if info["dtype"] not in _DTYPES:
            raise CheckpointError(
                f"{path}: tensor {name} has dtype {info['dtype']}; "
                f"the loader reads {sorted(_DTYPES)}"
            )
        np_dtype, dtype = _DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        a = raw[base + begin: base + end].view(np_dtype).reshape(info["shape"])
        out[name] = torch.from_numpy(a).view(dtype)
    return out


def _shard_files(path: str) -> list[str]:
    if os.path.isfile(path):
        return [path]
    index = os.path.join(path, "model.safetensors.index.json")
    if os.path.isfile(index):
        with open(index, encoding="utf-8") as f:
            weight_map: dict[str, str] = json.load(f)["weight_map"]
        files = sorted({os.path.join(path, v) for v in weight_map.values()})
    else:
        files = sorted(
            os.path.join(path, f) for f in os.listdir(path) if f.endswith(".safetensors")
        )
    if not files:
        raise CheckpointError(f"no .safetensors files under {path}")
    return files


def _rope_interleave_to_halfsplit(dr: int) -> torch.Tensor:
    """Column permutation from HF DeepSeek's interleaved rope pairs (dims
    2i, 2i+1 rotate together) to the half-split order ``apply_rope`` uses
    (dim j pairs with j + dr/2): applied once to the projection's columns,
    it is HF's runtime de-interleave."""
    return torch.cat([torch.arange(0, dr, 2), torch.arange(1, dr, 2)])


def _mla_layer(get, cfg: ModelConfig, i: int) -> dict[str, torch.Tensor]:
    """Layer i's MLA attention leaves, in the port's [in, out] layout."""
    m = cfg.mla
    H, d = cfg.num_heads, cfg.hidden_size
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    dq, rkv = dn + dr, m.kv_lora_rank
    perm = _rope_interleave_to_halfsplit(dr)
    names = dict(_MLA_NAMES)
    if m.q_lora_rank:
        names.update(_MLA_LOW_RANK_Q_NAMES)
    out = {}
    for key, fmt in names.items():
        t = get(fmt.format(i))
        out[key] = t.T if t.ndim == 2 else t
    q_name = "q_b_proj" if m.q_lora_rank else "q_proj"
    w = get(f"model.layers.{i}.self_attn.{q_name}.weight").T
    w = w.reshape(w.shape[0], H, dq)
    out["wuq" if m.q_lora_rank else "wq"] = torch.cat(
        [w[..., :dn], w[..., dn:][..., perm]], dim=-1
    ).reshape(w.shape[0], H * dq)
    w = get(f"model.layers.{i}.self_attn.kv_a_proj_with_mqa.weight").T  # [d, rkv + dr]
    out["wdkv"] = w[:, :rkv]
    out["wkr"] = w[:, rkv:][:, perm]
    w = get(f"model.layers.{i}.self_attn.o_proj.weight").T.reshape(H, dv, d)
    out["wo"] = torch.cat([w, w.new_zeros(H, dq - dv, d)], dim=1).reshape(H * dq, d)
    return out


def load_checkpoint(
    path: str,
    cfg: ModelConfig,
    dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device | None = None,
    quantize: str = "",
) -> dict[str, torch.Tensor]:
    """The state dict of a ``Llama(cfg, dtype, quantize=quantize)`` from
    the HF checkpoint at ``path`` (a directory or one file), in ``dtype``
    on ``device`` (the card unless the caller asks for the CPU). With
    ``quantize``, the weights are quantized on the host
    (``models.quant.quantize_params``) before they move to the device."""
    device = resolve_device(device)
    tensors: dict[str, torch.Tensor] = {}
    for file in _shard_files(path):
        tensors.update(read_safetensors(file))

    def get(name: str) -> torch.Tensor:
        if name not in tensors:
            raise CheckpointError(f"missing tensor {name} in checkpoint {path}")
        return tensors[name]

    attn_names = {k: v for k, v in _LAYER_NAMES.items() if k not in _DENSE_MLP_NAMES}
    if cfg.attn_bias:
        attn_names.update(_BIAS_NAMES)
    if cfg.qk_norm:
        attn_names.update(_QK_NORM_NAMES)
    dense = cfg.moe_layer_start if cfg.moe is not None else cfg.num_layers
    host: dict[str, torch.Tensor] = {
        "embed": get("model.embed_tokens.weight"),
        "final_norm": get("model.norm.weight"),
    }
    # Entries that keep f32 whatever the compute dtype: the router.
    exact: set[str] = set()
    for i in range(cfg.num_layers):
        names = {} if cfg.mla is not None else dict(attn_names)
        if cfg.mla is not None:
            host.update({f"layers.{i}.{k}": t for k, t in _mla_layer(get, cfg, i).items()})
        if i < dense:
            names.update(_DENSE_MLP_NAMES)
        elif cfg.moe.num_shared_experts:
            names.update(_SHARED_NAMES)
        for key, fmt in names.items():
            t = get(fmt.format(i))
            host[f"layers.{i}.{key}"] = t.T if t.ndim == 2 else t
        if i < dense:
            continue
        for key, fmt in _EXPERT_NAMES.items():
            host[f"layers.{i}.{key}"] = torch.stack([
                get(fmt.format(i, e)).T for e in range(cfg.moe.num_experts)
            ])
        host[f"layers.{i}.router"] = get(f"model.layers.{i}.mlp.gate.weight").T
        exact.add(f"layers.{i}.router")
        if cfg.moe.scoring_func == "sigmoid":
            host[f"layers.{i}.router_bias"] = get(
                f"model.layers.{i}.mlp.gate.e_score_correction_bias"
            )
            exact.add(f"layers.{i}.router_bias")
    head = tensors.get("lm_head.weight")
    if not cfg.tie_embeddings:
        if head is None:
            raise CheckpointError(
                "checkpoint has no lm_head.weight but config does not tie embeddings"
            )
        host["lm_head"] = head.T
    v, d = host["embed"].shape
    if (v, d) != (cfg.vocab_size, cfg.hidden_size):
        raise CheckpointError(
            f"embed shape {(v, d)} does not match config "
            f"({cfg.vocab_size}, {cfg.hidden_size})"
        )
    state = {
        k: t.to(torch.float32 if k in exact else dtype).contiguous()
        for k, t in host.items()
    }
    if quantize:
        state = quantize_params(state, quantize)
    return {k: t.to(device) for k, t in state.items()}


def write_safetensors(path: str, tensors: dict[str, torch.Tensor]) -> None:
    """Write ``tensors`` as one ``.safetensors`` file: the header (padded
    with spaces to 8 bytes, as the format's writers pad it), then each
    tensor's little-endian bytes in the header's order."""
    header: dict[str, dict] = {"__metadata__": {"format": "pt"}}
    blobs, offset = [], 0
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise CheckpointError(f"tensor {name} has dtype {t.dtype}; the writer takes "
                                  f"{sorted(_DTYPES)}")
        code, _ = _NAMES[t.dtype]
        t = t.detach().to("cpu").contiguous()
        a = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
        raw = a.astype(a.dtype.newbyteorder("<"), copy=False).tobytes()
        header[name] = {"dtype": code, "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for raw in blobs:
            f.write(raw)


def _mla_names(cfg: ModelConfig, i: int, get) -> dict[str, torch.Tensor]:
    """Layer i's MLA attention leaves under HF's names (the inverse of
    ``_mla_layer``): the rope columns back to HF's interleaved order,
    ``wdkv`` and ``wkr`` joined into ``kv_a_proj_with_mqa``, ``wo``'s pad
    rows cut."""
    m = cfg.mla
    H = cfg.num_heads
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    dq = dn + dr
    inv = torch.argsort(_rope_interleave_to_halfsplit(dr))
    names = dict(_MLA_NAMES)
    if m.q_lora_rank:
        names.update(_MLA_LOW_RANK_Q_NAMES)
    out = {}
    for key, fmt in names.items():
        t = get(key)
        out[fmt.format(i)] = t.T if t.ndim == 2 else t
    q_key, q_name = ("wuq", "q_b_proj") if m.q_lora_rank else ("wq", "q_proj")
    w = get(q_key)
    w = w.reshape(w.shape[0], H, dq)
    w = torch.cat([w[..., :dn], w[..., dn:][..., inv]], dim=-1).reshape(w.shape[0], H * dq)
    out[f"model.layers.{i}.self_attn.{q_name}.weight"] = w.T
    out[f"model.layers.{i}.self_attn.kv_a_proj_with_mqa.weight"] = torch.cat(
        [get("wdkv"), get("wkr")[:, inv]], dim=1).T
    wo = get("wo")
    out[f"model.layers.{i}.self_attn.o_proj.weight"] = (
        wo.reshape(H, dq, -1)[:, :dv].reshape(H * dv, -1).T)
    return out


def save_checkpoint(
    path: str, state: dict[str, torch.Tensor] | torch.nn.Module, cfg: ModelConfig,
) -> None:
    """Write a full-precision ``Llama`` (or its state dict) as one HF-named
    safetensors file at ``path``, each tensor in its own dtype: the names
    JAX's ``save_checkpoint`` writes (llama and DeepSeek MoE naming, the
    MLA split), matrices transposed back to HF's ``[out, in]``. It loads in
    the port's ``load_checkpoint`` and in JAX's to the same parameters."""
    if isinstance(state, torch.nn.Module):
        state = state.state_dict()
    if any(k.endswith((".q", ".scale")) for k in state):
        raise CheckpointError("save_checkpoint writes full-precision weights only")

    def layer_get(i: int):
        return lambda key: state[f"layers.{i}.{key}"]

    attn_names = {k: v for k, v in _LAYER_NAMES.items() if k not in _DENSE_MLP_NAMES}
    if cfg.attn_bias:
        attn_names.update(_BIAS_NAMES)
    if cfg.qk_norm:
        attn_names.update(_QK_NORM_NAMES)
    dense = cfg.moe_layer_start if cfg.moe is not None else cfg.num_layers
    flat: dict[str, torch.Tensor] = {}
    for i in range(cfg.num_layers):
        get = layer_get(i)
        names = {} if cfg.mla is not None else dict(attn_names)
        if cfg.mla is not None:
            flat.update(_mla_names(cfg, i, get))
        if i < dense:
            names.update(_DENSE_MLP_NAMES)
        elif cfg.moe.num_shared_experts:
            names.update(_SHARED_NAMES)
        for key, fmt in names.items():
            t = get(key)
            flat[fmt.format(i)] = t.T if t.ndim == 2 else t
        if i < dense:
            continue
        if cfg.moe.scoring_func == "sigmoid":
            flat[f"model.layers.{i}.mlp.gate.e_score_correction_bias"] = get("router_bias")
        flat[f"model.layers.{i}.mlp.gate.weight"] = get("router").T
        for key, fmt in _EXPERT_NAMES.items():
            stacked = get(key)
            for e in range(stacked.shape[0]):
                flat[fmt.format(i, e)] = stacked[e].T
    flat["model.embed_tokens.weight"] = state["embed"]
    flat["model.norm.weight"] = state["final_norm"]
    if not cfg.tie_embeddings:
        flat["lm_head.weight"] = state["lm_head"].T
    write_safetensors(path, flat)
