"""DeepSeek-V2 into the port. The port keeps W_uk and W_uv as one
``wukv`` [rkv, H, dn + dv] and ``wo`` over the qk head dim (rows past dv
in each head meet zeros in v; they are written zero here); every other
tensor has a port parameter of the same name and layout."""

from __future__ import annotations

from ..reference import deepseek_v2 as ref
from . import expect, write


def check(hf: dict, cfg) -> None:
    m = ref.dims(hf)
    mla, moe, rs = cfg.mla, cfg.moe, cfg.rope_scaling
    hrs = hf.get("rope_scaling") or {}
    expect({
        "hidden_size": (cfg.hidden_size, m["d"]), "heads": (cfg.num_heads, m["H"]),
        "vocab": (cfg.vocab_size, m["V"]), "layers": (cfg.num_layers, m["L"]),
        "intermediate_size": (cfg.intermediate_size, m["f"]),
        "rope_theta": (cfg.rope_theta, float(hf["rope_theta"])),
        "rms_norm_eps": (cfg.rms_norm_eps, hf["rms_norm_eps"]),
        "q_lora_rank": (mla.q_lora_rank, hf.get("q_lora_rank") or 0),
        "kv_lora_rank": (mla.kv_lora_rank, m["rkv"]), "qk_nope": (mla.qk_nope_head_dim, m["dn"]),
        "qk_rope": (mla.qk_rope_head_dim, m["dr"]), "v_head_dim": (mla.v_head_dim, m["dv"]),
        "experts": (moe.num_experts, m["E"]), "top_k": (moe.num_experts_per_token, m["k"]),
        "shared": (moe.num_shared_experts, m["ns"]),
        "expert_width": (moe.expert_intermediate_size, m["fe"]),
        "dense_layers": (cfg.moe_layer_start, m["dense"]),
        "norm_topk_prob": (moe.norm_topk_prob, bool(hf.get("norm_topk_prob"))),
        "routed_scaling": (moe.routed_scaling_factor, float(hf.get("routed_scaling_factor", 1.0))),
        "scoring": (moe.scoring_func, hf.get("scoring_func", "softmax")),
        "groups": ((moe.n_group, moe.topk_group), (hf.get("n_group") or 1, hf.get("topk_group") or 1)),
        "tied": (cfg.tie_embeddings, bool(hf.get("tie_word_embeddings"))),
        "yarn": ((rs.rope_type, rs.factor, rs.original_max_position, rs.beta_fast, rs.beta_slow,
                  rs.mscale, rs.mscale_all_dim) if rs else None,
                 (hrs["type"], float(hrs["factor"]), hrs["original_max_position_embeddings"],
                  float(hrs["beta_fast"]), float(hrs["beta_slow"]), float(hrs["mscale"]),
                  float(hrs["mscale_all_dim"])) if hrs else None),
    })


def load(model, hf: dict, maker) -> None:
    m = ref.dims(hf)
    H, dn, dr, dv, rkv = m["H"], m["dn"], m["dr"], m["dv"], m["rkv"]

    def put(params: dict, name: str, t) -> set[str]:
        layer, _, leaf = name.rpartition(".")
        if leaf in ("wuk", "wuv"):
            target = f"{layer}.wukv"
            view = params[target].view(rkv, H, dn + dv)
            if leaf == "wuk":
                view[:, :, :dn].copy_(t.view(rkv, H, dn))
            else:
                view[:, :, dn:].copy_(t.view(rkv, H, dv))
            return {target}
        if leaf == "wo":
            view = params[name].view(H, dn + dr, -1)
            view.zero_()
            view[:, :dv].copy_(t.view(H, dv, -1))
            return {name}
        params[name].copy_(t)
        return {name}

    write(model, ref.param_specs(hf), maker, put)
