"""Carry a JAX parameter tree into the port's ``Llama`` module.

``opsagent_tpu``'s dense parameter tree holds ``embed [V, d]``,
``final_norm [d]``, ``lm_head [d, V]`` and, under ``layers``, stacked
per-layer leaves ``[L, ...]`` in ``x @ w`` orientation (``wq [L, d, q]``).
The port keeps that orientation, so conversion only unstacks the layer axis.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .config import ModelConfig

LAYER_LEAVES = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "wg", "wu", "wd")


def params_from_jax(
    tree: Mapping[str, Any], cfg: ModelConfig
) -> dict[str, torch.Tensor]:
    """JAX parameter tree of numpy arrays -> ``Llama.load_state_dict``
    input (CPU tensors; ``load_state_dict`` casts and moves them)."""
    layers = tree["layers"]
    extra = set(layers) - set(LAYER_LEAVES)
    if extra or "moe_layers" in tree:
        raise NotImplementedError(
            f"parameter leaves {sorted(extra) or ['moe_layers']} belong to "
            "configurations this port does not serve yet"
        )
    state = {
        name: torch.from_numpy(np.array(tree[name]))
        for name in ("embed", "final_norm", "lm_head")
    }
    for name in LAYER_LEAVES:
        stacked = np.asarray(layers[name])
        if stacked.shape[0] != cfg.num_layers:
            raise ValueError(
                f"layers.{name} has {stacked.shape[0]} layers, "
                f"{cfg.name} has {cfg.num_layers}"
            )
        for i in range(cfg.num_layers):
            state[f"layers.{i}.{name}"] = torch.from_numpy(np.array(stacked[i]))
    return state
