"""Carry a JAX parameter tree into the port's ``Llama`` module.

``opsagent_tpu``'s dense parameter tree holds ``embed [V, d]``,
``final_norm [d]``, ``lm_head [d, V]`` and, under ``layers``, stacked
per-layer leaves ``[L, ...]`` in ``x @ w`` orientation (``wq [L, d, q]``).
The port keeps that orientation, so conversion only unstacks the layer axis.
Qwen2's biases (``bq bk bv``) and Qwen3's q/k norms (``qn kn``) carry
across when the tree has them; a tree with tied embeddings has no
``lm_head``.

A quantized leaf (``QuantizedLinear`` / ``QuantizedLinear4``, read
duck-typed by its ``.q`` and ``.scale``) becomes ``<name>.q`` and
``<name>.scale``: int8 ``q [L, In, Out]`` with ``scale [L, 1, Out]``, int4
``q [L, In/2, Out]`` with ``scale [L, G, 1, Out]``, and a 2-D quantized
``lm_head``. Load them into a ``Llama`` built with the same ``quantize``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .config import ModelConfig

LAYER_LEAVES = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "wg", "wu", "wd")
# Leaves of the attention variants: Qwen2 biases, Qwen3 q/k norms.
OPTIONAL_LAYER_LEAVES = ("bq", "bk", "bv", "qn", "kn")


def params_from_jax(
    tree: Mapping[str, Any], cfg: ModelConfig
) -> dict[str, torch.Tensor]:
    """JAX parameter tree of numpy arrays -> ``Llama.load_state_dict``
    input (CPU tensors; ``load_state_dict`` casts and moves them)."""
    layers = tree["layers"]
    extra = set(layers) - set(LAYER_LEAVES) - set(OPTIONAL_LAYER_LEAVES)
    if extra or "moe_layers" in tree:
        raise NotImplementedError(
            f"parameter leaves {sorted(extra) or ['moe_layers']} belong to "
            "configurations this port does not serve yet"
        )
    state: dict[str, torch.Tensor] = {}
    for name in ("embed", "final_norm", "lm_head"):
        if name not in tree:
            continue  # lm_head, with tied embeddings
        for key, a in _arrays(name, tree[name]):
            state[key] = torch.from_numpy(np.array(a))
    for name in (*LAYER_LEAVES, *(n for n in OPTIONAL_LAYER_LEAVES if n in layers)):
        for key, stacked in _arrays(name, layers[name]):
            if stacked.shape[0] != cfg.num_layers:
                raise ValueError(
                    f"layers.{name} has {stacked.shape[0]} layers, "
                    f"{cfg.name} has {cfg.num_layers}"
                )
            for i in range(cfg.num_layers):
                state[f"layers.{i}.{key}"] = torch.from_numpy(np.array(stacked[i]))
    return state


def _arrays(name: str, leaf: Any) -> list[tuple[str, np.ndarray]]:
    """A plain leaf -> [(name, array)]; a quantized one -> its codes and
    scales under ``name.q`` and ``name.scale``."""
    if hasattr(leaf, "q") and hasattr(leaf, "scale"):
        return [(f"{name}.q", np.asarray(leaf.q)),
                (f"{name}.scale", np.asarray(leaf.scale))]
    return [(name, np.asarray(leaf))]
