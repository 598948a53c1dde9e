"""Model configurations (the port's copy of ``opsagent_tpu.models.config``).

The port serves the dense families: Llama, Mistral, Qwen2 (q/k/v biases)
and Qwen3 (per-head q/k RMSNorm), with tied embeddings and llama3/YaRN rope
scaling. The mixture-of-experts and latent-attention fields are kept so
configurations read the same in both packages; ``models.llama`` raises
``NotImplementedError`` for them (ROADMAP queue 1 item 9).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Optional


@dataclass(frozen=True)
class RopeScalingConfig:
    """Long-context rope frequency scaling (``ops/rope.py`` implements the
    math). ``rope_type``: "llama3" (Llama-3.1's wavelength-banded
    interpolation) or "yarn" (NTK-by-parts with mscale)."""

    rope_type: str
    factor: float
    original_max_position: int
    # llama3
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    # yarn
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0


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
    rope_scaling: Optional[RopeScalingConfig] = None

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @property
    def q_size(self) -> int:
        return self.num_heads * self.head_dim_

    @property
    def kv_size(self) -> int:
        return self.num_kv_heads * self.head_dim_

    def num_params(self) -> int:
        """Approximate parameter count (dense layers): what the roofline
        attribution (obs/attribution.py) prices a weight stream by."""
        d, f, v = self.hidden_size, self.intermediate_size, self.vocab_size
        per_layer = (
            d * self.q_size + 2 * d * self.kv_size + self.q_size * d  # attn
            + 3 * d * f                                               # mlp
            + 2 * d                                                   # norms
        )
        embed = v * d * (1 if self.tie_embeddings else 2)
        return self.num_layers * per_layer + embed + d


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


QWEN25_7B = _register(
    ModelConfig(
        name="qwen2.5-7b-instruct",
        vocab_size=152064,
        hidden_size=3584,
        intermediate_size=18944,
        num_layers=28,
        num_heads=28,
        num_kv_heads=4,
        rope_theta=1000000.0,
        attn_bias=True,
        rms_norm_eps=1e-6,
        # Native window per the HF config (YaRN x4 to 128k is an opt-in
        # config edit upstream).
        max_position=32768,
    )
)


def get_config_preset(name: str) -> ModelConfig:
    if name in PRESETS:
        return PRESETS[name]
    raise KeyError(f"unknown model preset '{name}' (have: {sorted(PRESETS)})")


_DENSE_TYPES = ("llama", "mistral", "qwen2", "qwen3")
_MOE_MLA_TYPES = ("qwen3_moe", "deepseek", "deepseek_v2", "deepseek_v3")


def config_from_hf(path: str, name: str = "") -> ModelConfig:
    """A ``ModelConfig`` from an HF checkpoint directory's ``config.json``
    (or that file's path), for the dense model types llama, mistral, qwen2
    and qwen3. The mixture-of-experts and latent-attention types raise
    ``NotImplementedError``; a checkpoint that would use sliding-window
    attention raises ``ValueError`` rather than being served with full
    attention."""
    cfg_path = os.path.join(path, "config.json") if os.path.isdir(path) else path
    with open(cfg_path, encoding="utf-8") as f:
        hf = json.load(f)
    mt = hf.get("model_type", "llama")
    if mt in _MOE_MLA_TYPES:
        raise NotImplementedError(
            f"model_type {mt!r}: mixture-of-experts and latent attention are "
            "not ported yet (ROADMAP queue 1 item 9)"
        )
    if mt not in _DENSE_TYPES:
        raise ValueError(
            f"config_from_hf supports model_type {'/'.join(_DENSE_TYPES)}, got {mt!r}"
        )
    # Mistral v0.1 and Qwen2 with use_sliding_window use a window below the
    # position limit; later releases ship sliding_window null.
    sw = hf.get("sliding_window")
    sw_active = sw is not None and int(sw) < int(hf.get("max_position_embeddings", 8192))
    if mt in ("qwen2", "qwen3"):
        sw_active = sw_active and bool(hf.get("use_sliding_window", False))
    if sw_active:
        raise ValueError(
            f"checkpoint uses active sliding-window attention (sliding_window={sw}); "
            "this engine serves full paged attention only"
        )
    heads = int(hf["num_attention_heads"])
    return ModelConfig(
        name=name or os.path.basename(os.path.normpath(
            path if os.path.isdir(path) else os.path.dirname(cfg_path)
        )) or mt,
        vocab_size=int(hf["vocab_size"]),
        hidden_size=int(hf["hidden_size"]),
        intermediate_size=int(hf["intermediate_size"]),
        num_layers=int(hf["num_hidden_layers"]),
        num_heads=heads,
        num_kv_heads=int(hf.get("num_key_value_heads", heads)),
        head_dim=int(hf.get("head_dim") or 0),
        rope_theta=float(hf.get("rope_theta", 10000.0)),
        rms_norm_eps=float(hf.get("rms_norm_eps", 1e-5)),
        # Qwen2 checkpoints carry q/k/v biases without a flag; Qwen3 has
        # per-head q/k RMSNorm instead.
        attn_bias=mt == "qwen2" or bool(hf.get("attention_bias", False)),
        qk_norm=mt == "qwen3",
        tie_embeddings=bool(hf.get("tie_word_embeddings", False)),
        max_position=int(hf.get("max_position_embeddings", 8192)),
        rope_scaling=_rope_scaling_from_hf(hf.get("rope_scaling") or None),
    )


def _rope_scaling_from_hf(rs: dict | None) -> RopeScalingConfig | None:
    if not rs:
        return None
    rt = rs.get("rope_type") or rs.get("type")
    if rt == "llama3":
        return RopeScalingConfig(
            rope_type="llama3",
            factor=float(rs["factor"]),
            original_max_position=int(rs["original_max_position_embeddings"]),
            low_freq_factor=float(rs.get("low_freq_factor", 1.0)),
            high_freq_factor=float(rs.get("high_freq_factor", 4.0)),
        )
    if rt == "yarn":
        return RopeScalingConfig(
            rope_type="yarn",
            factor=float(rs["factor"]),
            original_max_position=int(rs["original_max_position_embeddings"]),
            beta_fast=float(rs.get("beta_fast", 32.0)),
            beta_slow=float(rs.get("beta_slow", 1.0)),
            mscale=float(rs.get("mscale", 1.0)),
            mscale_all_dim=float(rs.get("mscale_all_dim", 0.0)),
        )
    raise ValueError(f"unsupported rope_scaling type {rt!r}")


def resolve_model(model_name: str, checkpoint: str = "") -> ModelConfig:
    """The configuration a ``--model-name`` flag names: a preset, or with
    ``auto`` the one ``config_from_hf`` derives from the checkpoint
    directory (authoritative even when the directory's name is a
    preset's)."""
    if model_name != "auto":
        return get_config_preset(model_name)
    if not checkpoint:
        raise ValueError("--model-name auto requires --checkpoint")
    return config_from_hf(checkpoint)
