"""Carry a JAX parameter tree into the port's ``Llama`` module.

``opsagent_tpu``'s parameter tree holds ``embed [V, d]``, ``final_norm
[d]``, ``lm_head [d, V]`` and, under ``layers``, stacked per-layer leaves
``[L, ...]`` in ``x @ w`` orientation (``wq [L, d, q]``). A MoE model's
``layers`` holds its ``moe_layer_start`` dense layers and ``moe_layers``
the rest, with the router ``[Lm, d, E]`` (f32), the sigmoid router's
``router_bias [Lm, E]``, the stacked experts ``eg``/``eu``/``ed`` ``[Lm, E,
in, out]`` and the shared experts ``sg``/``su``/``sd``. MLA layers hold
``wq`` (or ``wdq``, ``q_norm``, ``wuq``), ``wdkv``, ``wkr``, ``kv_norm``,
``wukv`` and the padded ``wo`` in place of ``wq``/``wk``/``wv``/``wo``.
The port keeps that orientation, so conversion only unstacks the layer
axis: dense layer i is the port's layer i, MoE layer j its layer
``moe_layer_start + j``. Qwen2's biases and Qwen3's q/k norms carry across
when the tree has them; a tree with tied embeddings has no ``lm_head``.

A quantized leaf (``QuantizedLinear`` / ``QuantizedLinear4``, read
duck-typed by its ``.q`` and ``.scale``) becomes ``<name>.q`` and
``<name>.scale``, unstacked the same way (an expert leaf keeps its expert
axis). Load them into a ``Llama`` built with the same ``quantize``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .config import ModelConfig

# Leaves of an attention block: GQA (with Qwen2 biases, Qwen3 q/k norms),
# or MLA (full-rank or low-rank q).
ATTN_LEAVES = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm")
OPTIONAL_LAYER_LEAVES = ("bq", "bk", "bv", "qn", "kn")
MLA_LEAVES = ("attn_norm", "wdkv", "wkr", "kv_norm", "wukv", "wo", "mlp_norm")
MLA_Q_LEAVES = ("wq", "wdq", "q_norm", "wuq")
DENSE_MLP_LEAVES = ("wg", "wu", "wd")
MOE_LEAVES = ("router", "eg", "eu", "ed")
OPTIONAL_MOE_LEAVES = ("router_bias", "sg", "su", "sd")


def _stack_leaves(cfg: ModelConfig, moe: bool) -> tuple[tuple[str, ...], tuple[str, ...]]:
    """(required, optional) leaves of one stack of ``cfg``."""
    if cfg.mla is not None:
        required, optional = MLA_LEAVES, MLA_Q_LEAVES
    else:
        required, optional = ATTN_LEAVES, OPTIONAL_LAYER_LEAVES
    if moe:
        return required + MOE_LEAVES, optional + OPTIONAL_MOE_LEAVES
    return required + DENSE_MLP_LEAVES, optional


def params_from_jax(
    tree: Mapping[str, Any], cfg: ModelConfig
) -> dict[str, torch.Tensor]:
    """JAX parameter tree of numpy arrays -> ``Llama.load_state_dict``
    input (CPU tensors; ``load_state_dict`` casts and moves them)."""
    dense = cfg.moe_layer_start if cfg.moe is not None else cfg.num_layers
    stacks = [("layers", 0, dense, False)]
    if cfg.moe is not None:
        stacks.append(("moe_layers", dense, cfg.num_layers - dense, True))
    extra_stacks = set(tree) - {"embed", "final_norm", "lm_head"} - {s[0] for s in stacks}
    if extra_stacks:
        raise ValueError(f"parameter tree has {sorted(extra_stacks)}, {cfg.name} does not")
    state: dict[str, torch.Tensor] = {}
    for name in ("embed", "final_norm", "lm_head"):
        if name not in tree:
            continue  # lm_head, with tied embeddings
        for key, a in _arrays(name, tree[name]):
            state[key] = torch.from_numpy(np.array(a))
    for stack, first, count, moe in stacks:
        if count == 0:
            continue
        layers = tree[stack]
        required, optional = _stack_leaves(cfg, moe)
        extra = set(layers) - set(required) - set(optional)
        if extra:
            raise ValueError(f"{stack} has leaves {sorted(extra)} that {cfg.name} does not")
        for name in (*required, *(n for n in optional if n in layers)):
            for key, stacked in _arrays(name, layers[name]):
                if stacked.shape[0] != count:
                    raise ValueError(
                        f"{stack}.{name} has {stacked.shape[0]} layers, "
                        f"{cfg.name} has {count}"
                    )
                for i in range(count):
                    state[f"layers.{first + i}.{key}"] = torch.from_numpy(
                        np.array(stacked[i])
                    )
    return state


def _arrays(name: str, leaf: Any) -> list[tuple[str, np.ndarray]]:
    """A plain leaf -> [(name, array)]; a quantized one -> its codes and
    scales under ``name.q`` and ``name.scale``."""
    if hasattr(leaf, "q") and hasattr(leaf, "scale"):
        return [(f"{name}.q", np.asarray(leaf.q)),
                (f"{name}.scale", np.asarray(leaf.scale))]
    return [(name, np.asarray(leaf))]


# -- the other direction: the JAX package's stacked leaves --------------------
# numpy's names of the dtypes such leaves (and KV pages) hold: the names a
# snapshot manifest and the KV wire format record.
DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float16: "float16",
               torch.float32: "float32", torch.int8: "int8", torch.int32: "int32"}


def leaf_bytes(t: torch.Tensor) -> bytes:
    """A tensor's raw row-major bytes, as numpy's ``tobytes`` of the same
    array gives them (bf16 as its 16-bit words)."""
    return t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy().tobytes()


def _stack_names(cfg: ModelConfig, moe: bool) -> list[str]:
    """The leaf names of one stack of ``cfg``'s JAX parameter tree."""
    if cfg.mla is not None:
        names = list(MLA_LEAVES) + (["wdq", "q_norm", "wuq"] if cfg.mla.q_lora_rank else ["wq"])
    else:
        names = list(ATTN_LEAVES)
        if cfg.attn_bias:
            names += ["bq", "bk", "bv"]
        if cfg.qk_norm:
            names += ["qn", "kn"]
    if not moe:
        return names + list(DENSE_MLP_LEAVES)
    names += list(MOE_LEAVES)
    if cfg.moe.scoring_func == "sigmoid":
        names.append("router_bias")
    if cfg.moe.num_shared_experts:
        names += ["sg", "su", "sd"]
    return names


def jax_leaves(cfg: ModelConfig, quantize: str = "") -> list[tuple[str, str, int, int]]:
    """The JAX package's parameter leaves in its flatten order (sorted dict
    keys; a quantized weight's codes, then its scale), each as (keystr
    path, the port's state-dict key with ``{i}`` for the layer, first port
    layer, layer count; count 0 for a leaf without a layer axis). The
    paths equal ``opsagent_tpu/serving/snapshot/writer.py``'s
    ``spec_leaf_paths``."""
    from .quant import _QUANT_KEYS

    dense = cfg.moe_layer_start if cfg.moe is not None else cfg.num_layers
    tree: dict[str, tuple[list[str], int, int]] = {
        "embed": ([], 0, 0), "final_norm": ([], 0, 0),
        "layers": (_stack_names(cfg, False), 0, dense),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = ([], 0, 0)
    if cfg.moe is not None and cfg.num_layers > dense:
        tree["moe_layers"] = (_stack_names(cfg, True), dense, cfg.num_layers - dense)
    out: list[tuple[str, str, int, int]] = []

    def add(path: str, key: str, name: str, first: int, count: int) -> None:
        if quantize and name in _QUANT_KEYS:
            out.append((f"{path}[<flat index 0>]", f"{key}.q", first, count))
            out.append((f"{path}[<flat index 1>]", f"{key}.scale", first, count))
        else:
            out.append((path, key, first, count))

    for top in sorted(tree):
        names, first, count = tree[top]
        if not names:
            add(f"['{top}']", top, top, 0, 0)
            continue
        for name in sorted(names):
            add(f"['{top}']['{name}']", f"layers.{{i}}.{name}", name, first, count)
    return out


def spec_leaf_paths(cfg: ModelConfig, quantize: str = "") -> list[str]:
    """Keystr of every JAX parameter leaf, in flatten order: the leaf-file
    contract of an engine snapshot."""
    return [path for path, *_ in jax_leaves(cfg, quantize)]
