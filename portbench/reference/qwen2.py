"""Qwen2 (dense GQA) as its published config defines it, in plain float32
PyTorch: RMSNorm, q/k/v projections with biases, RoPE over the whole head
(theta from the config), causal grouped-query attention, o_proj, the
SiLU-gated MLP, untied lm_head. Weights [in, out], x @ W. Imports nothing
of the port.

The seeded weights are drawn so that each served token depends on the
token before it and on the context, as a trained model's does:

- the embedding's rows at std 1, the scale of what each layer adds to the
  residual stream (at the projections' fan-in std, 1/sqrt(hidden), the
  first layer's output drowns the token, the model's next token hardly
  depends on its last, and greedy replies fall into the same few tokens
  at margins that on some seeds no precision moves);
- the q and k projections at ``QK_SCALE`` times the fan-in std, attention
  logits of std ~2: attention over thousands of positions then weighs a
  few per cent of them. At 1x it averages the whole context, and at 3x
  (logits of std ~9) it is chaotic, bf16 parting from the reference
  almost as far as fp8 (PERF.md)."""

from __future__ import annotations

import torch

from ..weights import Spec
from . import common


def dims(hf: dict) -> dict[str, int]:
    d, H = hf["hidden_size"], hf["num_attention_heads"]
    return {"d": d, "H": H, "K": hf["num_key_value_heads"], "D": hf.get("head_dim") or d // H,
            "f": hf["intermediate_size"], "V": hf["vocab_size"], "L": hf["num_hidden_layers"]}


QK_SCALE = 2 ** 0.5


def param_specs(hf: dict) -> dict[str, list[Spec]]:
    if hf.get("tie_word_embeddings"):
        raise ValueError("the qwen2 reference holds an untied lm_head")
    m = dims(hf)
    d, q, kv, f = m["d"], m["H"] * m["D"], m["K"] * m["D"], m["f"]
    sharp = round(d / QK_SCALE ** 2)      # the fan-in whose std is QK_SCALE / sqrt(d)
    specs: dict[str, list[Spec]] = {"embed": [Spec("embed", (m["V"], d), fan_in=1)]}
    for i in range(m["L"]):
        p = f"layers.{i}."
        specs[f"layers.{i}"] = [
            Spec(p + "attn_norm", (d,), "norm"),
            Spec(p + "wq", (d, q), fan_in=sharp), Spec(p + "bq", (q,), "bias"),
            Spec(p + "wk", (d, kv), fan_in=sharp), Spec(p + "bk", (kv,), "bias"),
            Spec(p + "wv", (d, kv)), Spec(p + "bv", (kv,), "bias"),
            Spec(p + "wo", (q, d)),
            Spec(p + "mlp_norm", (d,), "norm"),
            Spec(p + "wg", (d, f)), Spec(p + "wu", (d, f)), Spec(p + "wd", (f, d)),
        ]
    specs["final"] = [Spec("final_norm", (d,), "norm"), Spec("lm_head", (d, m["V"]))]
    return specs


def logits_at(hf: dict, weights: common.WeightsFn, seqs: list[list[int]],
              positions: list[list[int]], device: torch.device,
              mm=torch.matmul) -> list[torch.Tensor]:
    m = dims(hf)
    eps, H, K, D = hf["rms_norm_eps"], m["H"], m["K"], m["D"]
    freqs = common.rope_freqs(D, float(hf["rope_theta"]), hf.get("rope_scaling"))

    def layer(i: int, x: torch.Tensor, W: dict, pos: torch.Tensor) -> torch.Tensor:
        S = x.shape[0]
        h = common.rms_norm(x, W["attn_norm"], eps)
        q = common.rotate((mm(h, W["wq"]) + W["bq"]).view(S, H, D), pos, freqs)
        k = common.rotate((mm(h, W["wk"]) + W["bk"]).view(S, K, D), pos, freqs)
        v = (mm(h, W["wv"]) + W["bv"]).view(S, K, D)
        x = x + mm(common.causal_attention(q, k, v, D ** -0.5).reshape(S, H * D), W["wo"])
        h = common.rms_norm(x, W["mlp_norm"], eps)
        return x + common.gated_mlp(h, W["wg"], W["wu"], W["wd"], mm)

    return common.logits_at(param_specs(hf), weights, layer, eps, seqs, positions, device, mm)
