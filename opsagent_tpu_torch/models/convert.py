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
