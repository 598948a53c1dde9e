"""HF safetensors checkpoints -> a ``Llama`` state dict (the port's
counterpart of ``opsagent_tpu/models/loader.py`` for dense models).

The HF llama-family names (``model.layers.N.self_attn.q_proj.weight``...)
map onto the port's module names; matrices are transposed from HF's
``[out, in]`` to the ``[in, out]`` the port keeps. Single-file and
index-sharded (``model.safetensors.index.json``) checkpoints load alike.
Qwen2's q/k/v biases and Qwen3's q/k norms load when the configuration
has them; a missing ``lm_head.weight`` is allowed only with tied
embeddings, and tied embeddings ignore one that is present.

The format is read here, without the ``safetensors`` package (the machine
beside the card has none): an 8-byte little-endian header length, a JSON
header of ``{name: {dtype, shape, data_offsets}}``, then the raw tensor
bytes, mapped with ``numpy.memmap``. F32, F16 and BF16 are read; BF16 as
uint16 viewed as ``torch.bfloat16``.
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
    if cfg.moe is not None or cfg.mla is not None:
        raise NotImplementedError(
            f"{cfg.name}: mixture-of-experts and latent-attention checkpoints "
            "are not ported yet (ROADMAP queue 1 item 9)"
        )
    device = resolve_device(device)
    tensors: dict[str, torch.Tensor] = {}
    for file in _shard_files(path):
        tensors.update(read_safetensors(file))

    def get(name: str) -> torch.Tensor:
        if name not in tensors:
            raise CheckpointError(f"missing tensor {name} in checkpoint {path}")
        return tensors[name]

    names = dict(_LAYER_NAMES)
    if cfg.attn_bias:
        names.update(_BIAS_NAMES)
    if cfg.qk_norm:
        names.update(_QK_NORM_NAMES)
    host: dict[str, torch.Tensor] = {
        "embed": get("model.embed_tokens.weight"),
        "final_norm": get("model.norm.weight"),
    }
    for i in range(cfg.num_layers):
        for key, fmt in names.items():
            t = get(fmt.format(i))
            host[f"layers.{i}.{key}"] = t.T if t.ndim == 2 else t
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
    state = {k: t.to(dtype).contiguous() for k, t in host.items()}
    if quantize:
        state = quantize_params(state, quantize)
    return {k: t.to(device) for k, t in state.items()}
