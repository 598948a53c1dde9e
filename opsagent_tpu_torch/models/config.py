"""Model configurations (the port's copy of ``opsagent_tpu.models.config``).

The port serves the dense families (Llama, Mistral, Qwen2 with q/k/v
biases, Qwen3 with per-head q/k RMSNorm), tied embeddings, llama3/YaRN rope
scaling, and the DeepSeek-style families: mixture-of-experts MLPs
(``MoEConfig``: DeepSeek-MoE, Qwen3-MoE, DeepSeek-V2/V3) and multi-head
latent attention (``MLAConfig``: DeepSeek-V2/V3).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    num_experts_per_token: int = 2
    num_shared_experts: int = 0
    expert_intermediate_size: int = 0  # 0 = use model intermediate_size
    # Combine weights as the HF config fields of the same names have them:
    # DeepSeek-MoE-16B / V2-Lite ship norm_topk_prob=false (raw softmax
    # probabilities), DeepSeek-V3 norm_topk_prob=true with scaling 2.5.
    norm_topk_prob: bool = False
    routed_scaling_factor: float = 1.0
    # Router scoring (HF scoring_func): "softmax" (DeepSeek-MoE/V2) or
    # "sigmoid" (V3, whose e_score_correction_bias steers selection only).
    scoring_func: str = "softmax"
    # Group-limited top-k (HF n_group/topk_group): only the topk_group best
    # of n_group expert groups are eligible. 1/1 disables.
    n_group: int = 1
    topk_group: int = 1
    # Grouped-dispatch policy of the JAX package's training path; serving
    # sets 0 (the all-experts form, the only one the port runs).
    grouped_dispatch_min_tokens: int = 512
    capacity_factor: float = 2.0


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2/V3): low-rank q and kv
    projections with a decoupled rope part shared by the heads. With
    ``latent_cache`` the pages hold one (kv_lora_rank + qk_rope_head_dim)
    latent per token and attention runs in the weight-absorbed MQA form;
    without it per-head k/v are materialized onto the standard cache, v
    zero-padded to the qk head dim."""

    q_lora_rank: int = 0           # 0 = full-rank q projection (V2-Lite)
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    latent_cache: bool = False

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        return self.kv_lora_rank + self.qk_rope_head_dim


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
    moe: Optional[MoEConfig] = None
    moe_layer_start: int = 0         # dense layers before the first MoE layer
    # MLA: head_dim == mla.qk_head_dim and num_kv_heads == num_heads.
    mla: Optional[MLAConfig] = None
    rope_scaling: Optional[RopeScalingConfig] = None

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @property
    def rope_dim_(self) -> int:
        """Dims RoPE rotates: the decoupled rope part under MLA, the whole
        head otherwise."""
        return self.mla.qk_rope_head_dim if self.mla else self.head_dim_

    @property
    def q_size(self) -> int:
        return self.num_heads * self.head_dim_

    @property
    def kv_size(self) -> int:
        return self.num_kv_heads * self.head_dim_

    def num_params(self) -> int:
        """Approximate parameter count (dense layers, as the JAX package
        counts it, MoE and MLA models too): what the roofline attribution
        (obs/attribution.py) prices a weight stream by."""
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


# DeepSeek-MoE-16B (GQA + MoE; the pre-MLA DeepSeek generation).
DEEPSEEK_MOE_16B = _register(
    ModelConfig(
        name="deepseek-moe-16b",
        vocab_size=102400,
        hidden_size=2048,
        intermediate_size=10944,
        num_layers=28,
        num_heads=16,
        num_kv_heads=16,
        rope_theta=10000.0,
        moe=MoEConfig(
            num_experts=64,
            num_experts_per_token=6,
            num_shared_experts=2,
            expert_intermediate_size=1408,
        ),
        moe_layer_start=1,
    )
)

# DeepSeek-V2-Lite (MLA + MoE, HF deepseek_v2): full-rank q, compressed kv,
# 64 routed experts top-6 plus 2 shared, YaRN to a 160k window.
DEEPSEEK_V2_LITE = _register(
    ModelConfig(
        name="deepseek-v2-lite",
        vocab_size=102400,
        hidden_size=2048,
        intermediate_size=10944,
        num_layers=27,
        num_heads=16,
        num_kv_heads=16,
        head_dim=192,               # qk_nope (128) + qk_rope (64)
        rope_theta=10000.0,
        rms_norm_eps=1e-6,
        max_position=163840,
        rope_scaling=RopeScalingConfig(
            rope_type="yarn",
            factor=40.0,
            original_max_position=4096,
            beta_fast=32.0,
            beta_slow=1.0,
            mscale=0.707,
            mscale_all_dim=0.707,
        ),
        moe=MoEConfig(
            num_experts=64,
            num_experts_per_token=6,
            num_shared_experts=2,
            expert_intermediate_size=1408,
        ),
        moe_layer_start=1,
        mla=MLAConfig(
            q_lora_rank=0,
            kv_lora_rank=512,
            qk_nope_head_dim=128,
            qk_rope_head_dim=64,
            v_head_dim=128,
            latent_cache=True,
        ),
    )
)

# DeepSeek-V3 (671B total / 37B active): low-rank q, 256 routed experts
# top-8 plus 1 shared, sigmoid scoring with the selection bias, group-limited
# top-k (8 groups, 4 kept), norm_topk_prob and routed scaling 2.5.
DEEPSEEK_V3 = _register(
    ModelConfig(
        name="deepseek-v3",
        vocab_size=129280,
        hidden_size=7168,
        intermediate_size=18432,
        num_layers=61,
        num_heads=128,
        num_kv_heads=128,
        head_dim=192,
        rope_theta=10000.0,
        rms_norm_eps=1e-6,
        max_position=163840,
        rope_scaling=RopeScalingConfig(
            rope_type="yarn",
            factor=40.0,
            original_max_position=4096,
            beta_fast=32.0,
            beta_slow=1.0,
            mscale=1.0,
            mscale_all_dim=1.0,
        ),
        moe=MoEConfig(
            num_experts=256,
            num_experts_per_token=8,
            num_shared_experts=1,
            expert_intermediate_size=2048,
            norm_topk_prob=True,
            routed_scaling_factor=2.5,
            scoring_func="sigmoid",
            n_group=8,
            topk_group=4,
        ),
        moe_layer_start=3,
        mla=MLAConfig(
            q_lora_rank=1536,
            kv_lora_rank=512,
            qk_nope_head_dim=128,
            qk_rope_head_dim=64,
            v_head_dim=128,
            latent_cache=True,
        ),
    )
)

TINY_MLA = _register(
    ModelConfig(
        name="tiny-mla",
        vocab_size=512,
        hidden_size=64,
        intermediate_size=128,
        num_layers=2,
        num_heads=4,
        num_kv_heads=4,
        head_dim=24,                # 16 nope + 8 rope
        rope_theta=10000.0,
        max_position=2048,
        mla=MLAConfig(
            q_lora_rank=32,
            kv_lora_rank=32,
            qk_nope_head_dim=16,
            qk_rope_head_dim=8,
            v_head_dim=16,
        ),
    )
)

TINY_MOE = _register(
    ModelConfig(
        name="tiny-moe",
        vocab_size=512,
        hidden_size=64,
        intermediate_size=128,
        num_layers=2,
        num_heads=4,
        num_kv_heads=2,
        rope_theta=10000.0,
        max_position=2048,
        moe=MoEConfig(
            num_experts=4,
            num_experts_per_token=2,
            num_shared_experts=1,
            expert_intermediate_size=64,
        ),
        moe_layer_start=1,
    )
)


def get_config_preset(name: str) -> ModelConfig:
    if name in PRESETS:
        return PRESETS[name]
    raise KeyError(f"unknown model preset '{name}' (have: {sorted(PRESETS)})")


_HF_TYPES = ("llama", "mistral", "qwen2", "qwen3", "qwen3_moe",
             "deepseek", "deepseek_v2", "deepseek_v3")


def config_from_hf(path: str, name: str = "") -> ModelConfig:
    """A ``ModelConfig`` from an HF checkpoint directory's ``config.json``
    (or that file's path): model types llama, mistral, qwen2, qwen3,
    qwen3_moe, deepseek, deepseek_v2 and deepseek_v3, with the JAX
    package's refusals: a checkpoint that would use sliding-window
    attention, interleaved dense and MoE layers (qwen3_moe
    ``mlp_only_layers`` or ``decoder_sparse_step`` != 1, deepseek
    ``moe_layer_freq`` != 1) and an unknown router ``scoring_func`` raise
    ``ValueError``. DeepSeek-V2/V3 serve from the latent cache."""
    cfg_path = os.path.join(path, "config.json") if os.path.isdir(path) else path
    with open(cfg_path, encoding="utf-8") as f:
        hf = json.load(f)
    mt = hf.get("model_type", "llama")
    if mt not in _HF_TYPES:
        raise ValueError(
            f"config_from_hf supports model_type {'/'.join(_HF_TYPES)}, got {mt!r}"
        )
    # Mistral v0.1 and Qwen2 with use_sliding_window use a window below the
    # position limit; later releases ship sliding_window null.
    sw = hf.get("sliding_window")
    sw_active = sw is not None and int(sw) < int(hf.get("max_position_embeddings", 8192))
    if mt in ("qwen2", "qwen3", "qwen3_moe"):
        sw_active = sw_active and bool(hf.get("use_sliding_window", False))
    if sw_active and not mt.startswith("deepseek"):
        raise ValueError(
            f"checkpoint uses active sliding-window attention (sliding_window={sw}); "
            "this engine serves full paged attention only"
        )
    moe = mla = None
    moe_layer_start = 0
    if mt == "qwen3_moe":
        # DeepSeek weight names, its own config keys, softmax routing, no
        # shared experts; every layer MoE.
        if hf.get("mlp_only_layers"):
            raise ValueError("qwen3_moe mlp_only_layers interleaving is not supported")
        if int(hf.get("decoder_sparse_step", 1) or 1) != 1:
            raise ValueError("only decoder_sparse_step=1 (every layer MoE) is supported")
        moe = MoEConfig(
            num_experts=int(hf["num_experts"]),
            num_experts_per_token=int(hf["num_experts_per_tok"]),
            num_shared_experts=0,
            expert_intermediate_size=int(hf["moe_intermediate_size"]),
            norm_topk_prob=bool(hf.get("norm_topk_prob", False)),
            routed_scaling_factor=1.0,
            scoring_func="softmax",
            n_group=1,
            topk_group=1,
        )
    if mt.startswith("deepseek"):
        if int(hf.get("moe_layer_freq", 1)) != 1:
            raise ValueError(
                "only moe_layer_freq=1 (contiguous MoE stack after the "
                "dense prefix) is supported"
            )
        if hf.get("n_routed_experts"):
            scoring = hf.get("scoring_func", "softmax")
            if scoring not in ("softmax", "sigmoid"):
                raise ValueError(f"unsupported router scoring_func {scoring!r}")
            moe = MoEConfig(
                num_experts=int(hf["n_routed_experts"]),
                num_experts_per_token=int(hf["num_experts_per_tok"]),
                num_shared_experts=int(hf.get("n_shared_experts", 0) or 0),
                expert_intermediate_size=int(hf.get("moe_intermediate_size", 0) or 0),
                norm_topk_prob=bool(hf.get("norm_topk_prob", False)),
                routed_scaling_factor=float(hf.get("routed_scaling_factor", 1.0)),
                scoring_func=scoring,
                n_group=int(hf.get("n_group", 1) or 1),
                topk_group=int(hf.get("topk_group", 1) or 1),
            )
            moe_layer_start = int(hf.get("first_k_dense_replace", 0))
        if mt in ("deepseek_v2", "deepseek_v3"):
            mla = MLAConfig(
                q_lora_rank=int(hf.get("q_lora_rank") or 0),
                kv_lora_rank=int(hf["kv_lora_rank"]),
                qk_nope_head_dim=int(hf["qk_nope_head_dim"]),
                qk_rope_head_dim=int(hf["qk_rope_head_dim"]),
                v_head_dim=int(hf["v_head_dim"]),
                latent_cache=True,
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
        # MLA has no GQA: the latent is the compression.
        num_kv_heads=heads if mla else int(hf.get("num_key_value_heads", heads)),
        head_dim=mla.qk_head_dim if mla else int(hf.get("head_dim") or 0),
        rope_theta=float(hf.get("rope_theta", 10000.0)),
        rms_norm_eps=float(hf.get("rms_norm_eps", 1e-5)),
        # Qwen2 checkpoints carry q/k/v biases without a flag; Qwen3 has
        # per-head q/k RMSNorm instead.
        attn_bias=mt == "qwen2" or bool(hf.get("attention_bias", False)),
        qk_norm=mt in ("qwen3", "qwen3_moe"),
        tie_embeddings=bool(hf.get("tie_word_embeddings", False)),
        max_position=int(hf.get("max_position_embeddings", 8192)),
        moe=moe,
        moe_layer_start=moe_layer_start,
        mla=mla,
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
