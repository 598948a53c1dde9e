"""DeepSeek-V2 (MLA + MoE) as its published config defines it, in plain
float32 PyTorch, in the paper's non-absorbed form: a full-rank q (V2-Lite
has no q compression) split into a no-rope and a rope part; the kv latent
c = RMSNorm(h W_dkv), per-head keys c W_uk and values c W_uv; a rope key
h W_kr shared by the heads; YaRN on both rope parts and the softmax scale
times mscale(factor, mscale_all_dim)^2; the first ``first_k_dense_replace``
layers with a dense MLP, then softmax routing over ``n_routed_experts``,
the top ``num_experts_per_tok`` weighted by their probabilities (no
renormalisation when ``norm_topk_prob`` is false, times
``routed_scaling_factor``), plus the shared experts as one MLP of
``n_shared_experts`` widths. Weights [in, out], experts [E, in, out].

RoPE pairs dim i with i + dim/2 here; the published checkpoints order
the rope columns in interleaved pairs, a fixed permutation of the same
weights that the seeded weights make immaterial. Imports nothing of the
port."""

from __future__ import annotations

import torch

from ..weights import Spec
from . import common


def dims(hf: dict) -> dict[str, int]:
    return {
        "d": hf["hidden_size"], "H": hf["num_attention_heads"], "V": hf["vocab_size"],
        "L": hf["num_hidden_layers"], "f": hf["intermediate_size"],
        "fe": hf["moe_intermediate_size"], "E": hf["n_routed_experts"],
        "k": hf["num_experts_per_tok"], "ns": hf["n_shared_experts"] or 0,
        "dn": hf["qk_nope_head_dim"], "dr": hf["qk_rope_head_dim"], "dv": hf["v_head_dim"],
        "rkv": hf["kv_lora_rank"], "dense": hf["first_k_dense_replace"],
    }


def param_specs(hf: dict) -> dict[str, list[Spec]]:
    if hf.get("q_lora_rank"):
        raise ValueError("the deepseek_v2 reference holds a full-rank q (q_lora_rank null)")
    if hf.get("moe_layer_freq", 1) != 1 or hf.get("tie_word_embeddings"):
        raise ValueError("the deepseek_v2 reference holds MoE in every layer past the "
                         "dense ones and an untied lm_head")
    m = dims(hf)
    d, H, E, fe = m["d"], m["H"], m["E"], m["fe"]
    specs: dict[str, list[Spec]] = {"embed": [Spec("embed", (m["V"], d), fan_in=d)]}
    for i in range(m["L"]):
        p = f"layers.{i}."
        layer = [
            Spec(p + "attn_norm", (d,), "norm"),
            Spec(p + "wq", (d, H * (m["dn"] + m["dr"]))),
            Spec(p + "wdkv", (d, m["rkv"])), Spec(p + "wkr", (d, m["dr"])),
            Spec(p + "kv_norm", (m["rkv"],), "norm"),
            Spec(p + "wuk", (m["rkv"], H * m["dn"])), Spec(p + "wuv", (m["rkv"], H * m["dv"])),
            Spec(p + "wo", (H * m["dv"], d)),
            Spec(p + "mlp_norm", (d,), "norm"),
        ]
        if i < m["dense"]:
            layer += [Spec(p + "wg", (d, m["f"])), Spec(p + "wu", (d, m["f"])),
                      Spec(p + "wd", (m["f"], d))]
        else:
            layer += [Spec(p + "router", (d, E), dtype="float32"),
                      Spec(p + "eg", (E, d, fe)), Spec(p + "eu", (E, d, fe)),
                      Spec(p + "ed", (E, fe, d))]
            if m["ns"]:
                fs = fe * m["ns"]
                layer += [Spec(p + "sg", (d, fs)), Spec(p + "su", (d, fs)), Spec(p + "sd", (fs, d))]
        specs[f"layers.{i}"] = layer
    specs["final"] = [Spec("final_norm", (d,), "norm"), Spec("lm_head", (d, m["V"]))]
    return specs


def moe(h: torch.Tensor, W: dict, hf: dict, mm=torch.matmul) -> torch.Tensor:
    """Routed experts over tokens h [T, d] plus the shared experts."""
    m = dims(hf)
    probs = torch.softmax(h @ W["router"], dim=-1)
    w, idx = probs.topk(m["k"], dim=-1)
    if hf.get("norm_topk_prob"):
        w = w / w.sum(-1, keepdim=True)
    w = w * float(hf.get("routed_scaling_factor", 1.0))
    out = torch.zeros_like(h)
    for e in idx.unique().tolist():
        tok, slot = (idx == e).nonzero(as_tuple=True)
        y = common.gated_mlp(h[tok], W["eg"][e], W["eu"][e], W["ed"][e], mm)
        out.index_add_(0, tok, y * w[tok, slot, None])
    if m["ns"]:
        out = out + common.gated_mlp(h, W["sg"], W["su"], W["sd"], mm)
    return out


def logits_at(hf: dict, weights: common.WeightsFn, seqs: list[list[int]],
              positions: list[list[int]], device: torch.device,
              mm=torch.matmul) -> list[torch.Tensor]:
    m = dims(hf)
    eps, H, dn, dr, dv = hf["rms_norm_eps"], m["H"], m["dn"], m["dr"], m["dv"]
    rs = hf.get("rope_scaling")
    freqs = common.rope_freqs(dr, float(hf["rope_theta"]), rs)
    scale = (dn + dr) ** -0.5
    if rs:
        scale *= common.yarn_mscale(float(rs["factor"]), rs.get("mscale_all_dim", 0.0)) ** 2

    def layer(i: int, x: torch.Tensor, W: dict, pos: torch.Tensor) -> torch.Tensor:
        S = x.shape[0]
        h = common.rms_norm(x, W["attn_norm"], eps)
        q = mm(h, W["wq"]).view(S, H, dn + dr)
        c = common.rms_norm(mm(h, W["wdkv"]), W["kv_norm"], eps)
        k_rope = common.rotate(mm(h, W["wkr"]).view(S, 1, dr), pos, freqs)
        q = torch.cat([q[..., :dn], common.rotate(q[..., dn:], pos, freqs)], dim=-1)
        k = torch.cat([mm(c, W["wuk"]).view(S, H, dn), k_rope.expand(S, H, dr)], dim=-1)
        v = mm(c, W["wuv"]).view(S, H, dv)
        x = x + mm(common.causal_attention(q, k, v, scale).reshape(S, H * dv), W["wo"])
        h = common.rms_norm(x, W["mlp_norm"], eps)
        if i < m["dense"]:
            return x + common.gated_mlp(h, W["wg"], W["wu"], W["wd"], mm)
        return x + moe(h, W, hf, mm)

    return common.logits_at(param_specs(hf), weights, layer, eps, seqs, positions, device, mm)
