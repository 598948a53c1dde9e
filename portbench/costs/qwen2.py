"""Operations and bytes of Qwen2 (dense GQA) from its config shapes; the
module docstring of ``costs`` says what each function counts."""

from __future__ import annotations

from ..reference.qwen2 import dims

BYTES = 2  # bf16


def params(hf: dict) -> dict[str, int]:
    m = dims(hf)
    d, q, kv, f = m["d"], m["H"] * m["D"], m["K"] * m["D"], m["f"]
    layer = d * q + 2 * d * kv + q * d + q + 2 * kv + 3 * d * f + 2 * d
    body = m["L"] * layer
    head = d * m["V"]
    return {"total": body + 2 * head + d, "active": body + head + d, "body_active": body}


def kv_token_bytes(hf: dict) -> int:
    m = dims(hf)
    return m["L"] * 2 * m["K"] * m["D"] * BYTES


def attn_flops(hf: dict, pairs: float) -> float:
    m = dims(hf)
    return m["L"] * m["H"] * 4 * m["D"] * pairs          # QK^T and PV, 2 * D each


def attn_bytes(hf: dict, q_tokens: float, kv_tokens: float) -> float:
    m = dims(hf)
    return kv_tokens * kv_token_bytes(hf) + q_tokens * m["L"] * 2 * m["H"] * m["D"] * BYTES


def model_flops(hf: dict, q_tokens: float, pairs: float) -> float:
    return 2.0 * params(hf)["body_active"] * q_tokens + attn_flops(hf, pairs)
