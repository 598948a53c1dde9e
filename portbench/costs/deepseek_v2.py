"""Operations and bytes of DeepSeek-V2 (MLA + MoE) from its config shapes;
the module docstring of ``costs`` says what each function counts.

Attention is priced in the weight-absorbed form over the latent cache,
the form that serving from latents needs: each (query, position) pair a
score over the latent [c, k_rope] (2 (rkv + dr) a head) and a weighted sum
of c (2 rkv a head); a cached token holds rkv + dr values a layer. The
absorbed projections W_uk, W_uv are counted once a query token as
parameters. Active parameters: attention, the dense layers' MLP, and in
each MoE layer the router, ``num_experts_per_tok`` routed experts and
the shared ones."""

from __future__ import annotations

from ..reference.deepseek_v2 import dims

BYTES = 2  # bf16


def params(hf: dict) -> dict[str, int]:
    m = dims(hf)
    d, H = m["d"], m["H"]
    attn = (d * H * (m["dn"] + m["dr"]) + d * (m["rkv"] + m["dr"]) + m["rkv"]
            + m["rkv"] * H * (m["dn"] + m["dv"]) + H * m["dv"] * d + 2 * d)
    expert = 3 * d * m["fe"]
    dense = m["dense"] * (attn + 3 * d * m["f"])
    n_moe = m["L"] - m["dense"]
    moe_total = n_moe * (attn + d * m["E"] + m["E"] * expert + m["ns"] * expert)
    moe_active = n_moe * (attn + d * m["E"] + m["k"] * expert + m["ns"] * expert)
    head = d * m["V"]
    return {"total": dense + moe_total + 2 * head + d,
            "active": dense + moe_active + head + d,
            "body_active": dense + moe_active}


def kv_token_bytes(hf: dict) -> int:
    m = dims(hf)
    return m["L"] * (m["rkv"] + m["dr"]) * BYTES


def attn_flops(hf: dict, pairs: float) -> float:
    m = dims(hf)
    return m["L"] * m["H"] * (2 * (m["rkv"] + m["dr"]) + 2 * m["rkv"]) * pairs


def attn_bytes(hf: dict, q_tokens: float, kv_tokens: float) -> float:
    m = dims(hf)
    per_q = m["H"] * ((m["rkv"] + m["dr"]) + m["rkv"]) * BYTES   # q_lat in, latent ctx out
    return kv_tokens * kv_token_bytes(hf) + q_tokens * m["L"] * per_q


def model_flops(hf: dict, q_tokens: float, pairs: float) -> float:
    return 2.0 * params(hf)["body_active"] * q_tokens + attn_flops(hf, pairs)
