"""Model configurations (the port's copy of ``opsagent_tpu.models.config``).

Only the dense Llama family is served by this port so far. The fields for
mixture-of-experts, latent attention, per-head q/k norms and rope scaling are
kept so configurations read the same in both packages; ``models.llama``
raises ``NotImplementedError`` for any of them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional


@dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int = 0  # 0 = hidden_size // num_heads
    rope_theta: float = 500000.0
    rms_norm_eps: float = 1e-5
    attn_bias: bool = False          # Qwen2-style q/k/v biases
    qk_norm: bool = False            # Qwen3-style per-head q/k RMSNorm
    tie_embeddings: bool = False
    max_position: int = 131072
    moe: Optional[Any] = None
    moe_layer_start: int = 0
    mla: Optional[Any] = None
    rope_scaling: Optional[Any] = None

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @property
    def q_size(self) -> int:
        return self.num_heads * self.head_dim_

    @property
    def kv_size(self) -> int:
        return self.num_kv_heads * self.head_dim_


PRESETS: dict[str, ModelConfig] = {}


def _register(cfg: ModelConfig) -> ModelConfig:
    PRESETS[cfg.name] = cfg
    return cfg


TINY_TEST = _register(
    ModelConfig(
        name="tiny-test",
        vocab_size=512,
        hidden_size=64,
        intermediate_size=128,
        num_layers=2,
        num_heads=4,
        num_kv_heads=2,
        rope_theta=10000.0,
        max_position=16384,
    )
)

BENCH_1B = _register(
    ModelConfig(
        name="bench-1b",
        vocab_size=128256,
        hidden_size=2048,
        intermediate_size=8192,
        num_layers=16,
        num_heads=32,
        num_kv_heads=8,
        rope_theta=500000.0,
    )
)

# Exactly the Llama-3-8B architecture; random weights unless loaded.
BENCH_8B = _register(
    ModelConfig(
        name="bench-8b",
        vocab_size=128256,
        hidden_size=4096,
        intermediate_size=14336,
        num_layers=32,
        num_heads=32,
        num_kv_heads=8,
        rope_theta=500000.0,
        max_position=8192,
    )
)

LLAMA3_8B = _register(
    ModelConfig(
        name="llama-3-8b-instruct",
        vocab_size=128256,
        hidden_size=4096,
        intermediate_size=14336,
        num_layers=32,
        num_heads=32,
        num_kv_heads=8,
        rope_theta=500000.0,
        max_position=8192,
    )
)


def get_config_preset(name: str) -> ModelConfig:
    if name in PRESETS:
        return PRESETS[name]
    raise KeyError(f"unknown model preset '{name}' (have: {sorted(PRESETS)})")
