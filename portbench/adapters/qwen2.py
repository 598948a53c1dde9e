"""Qwen2 into the port: every published tensor has a port parameter of the
same name and layout."""

from __future__ import annotations

from ..reference import qwen2 as ref
from . import expect, write


def check(hf: dict, cfg) -> None:
    m = ref.dims(hf)
    expect({
        "hidden_size": (cfg.hidden_size, m["d"]), "heads": (cfg.num_heads, m["H"]),
        "kv_heads": (cfg.num_kv_heads, m["K"]), "head_dim": (cfg.head_dim_, m["D"]),
        "intermediate_size": (cfg.intermediate_size, m["f"]), "vocab": (cfg.vocab_size, m["V"]),
        "layers": (cfg.num_layers, m["L"]), "rope_theta": (cfg.rope_theta, float(hf["rope_theta"])),
        "rms_norm_eps": (cfg.rms_norm_eps, hf["rms_norm_eps"]), "attn_bias": (cfg.attn_bias, True),
        "tied": (cfg.tie_embeddings, bool(hf.get("tie_word_embeddings"))),
        "qk_norm": (cfg.qk_norm, False), "moe": (cfg.moe, None), "mla": (cfg.mla, None),
        "rope_scaling": (cfg.rope_scaling, None),
    })


def _put(params: dict, name: str, t) -> set[str]:
    params[name].copy_(t)
    return {name}


def load(model, hf: dict, maker) -> None:
    write(model, ref.param_specs(hf), maker, _put)
