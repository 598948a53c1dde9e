"""Tiny configurations of each family for the CPU tests: the real
configuration files with every size cut down, and ``port_config``, which
builds the port's ``ModelConfig`` of one: the same preset with the
port's fields cut to match (the tests put it in place of the adapters'
``port_config``)."""

from __future__ import annotations

import json
from dataclasses import fields, is_dataclass, replace
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]


def qwen2() -> dict:
    conf = json.loads((PKG / "configs" / "qwen2.5-7b.json").read_text())
    sizes = {"vocab_size": 512, "hidden_size": 64, "intermediate_size": 96,
             "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2}
    conf.update(sizes, token_range=[0, 500])
    conf["engine"] = dict(conf["engine"], num_pages=512, max_batch_size=4, max_pages_per_seq=64)
    return conf


def deepseek_v2() -> dict:
    conf = json.loads((PKG / "configs" / "deepseek-v2-lite.json").read_text())
    sizes = {"vocab_size": 512, "hidden_size": 64, "intermediate_size": 96,
             "num_hidden_layers": 3, "num_attention_heads": 4, "num_key_value_heads": 4,
             "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
             "v_head_dim": 16, "n_routed_experts": 4, "num_experts_per_tok": 2,
             "n_shared_experts": 1, "moe_intermediate_size": 32}
    conf.update(sizes, token_range=[0, 500])
    conf["engine"] = dict(conf["engine"], num_pages=512, max_batch_size=4, max_pages_per_seq=64)
    return conf


FAMILIES = {"qwen2": qwen2, "deepseek_v2": deepseek_v2}

# The port's fields of each family's tiny configuration (nested groups as
# dicts of their fields).
PORT = {
    "qwen2": {"vocab_size": 512, "hidden_size": 64, "intermediate_size": 96, "num_layers": 2,
              "num_heads": 4, "num_kv_heads": 2, "max_position": 4096},
    "deepseek_v2": {
        "vocab_size": 512, "hidden_size": 64, "intermediate_size": 96, "num_layers": 3,
        "num_heads": 4, "num_kv_heads": 4, "head_dim": 24, "max_position": 4096,
        "moe": {"num_experts": 4, "num_experts_per_token": 2, "num_shared_experts": 1,
                "expert_intermediate_size": 32},
        "mla": {"kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
                "v_head_dim": 16},
    },
}


def port_config(conf: dict):
    """The port's ``ModelConfig`` of a tiny configuration."""
    from opsagent_tpu_torch.models.config import get_config_preset

    return _override(get_config_preset(conf["preset"]), PORT[conf["family"]])


def _override(obj, changes: dict):
    names = {f.name for f in fields(obj)}
    out = {}
    for key, val in changes.items():
        if key not in names:
            raise ValueError(f"{type(obj).__name__} has no field {key!r}")
        cur = getattr(obj, key)
        out[key] = _override(cur, val) if is_dataclass(cur) and isinstance(val, dict) else val
    return replace(obj, **out)

TINY_MIX = {
    "clients": 3,
    "prefixes": {"count": 2, "tokens": {"dist": "uniform", "lo": 40, "hi": 70}},
    "prefix_setup": "split_lane",
    "carry": True,
    "stagger": True,
    "max_turns": 4,
    "max_context": 300,
    "first_tokens": {"dist": "uniform", "lo": 4, "hi": 8},
    "new_tokens": {"dist": "loguniform", "lo": 8, "hi": 40},
    "reply_tokens": {"dist": "loguniform", "lo": 3, "hi": 12},
    "think_s": {"dist": "uniform", "lo": 0.0, "hi": 0.05},
}
