"""The frozen arithmetic of ``portbench/costs`` against the published
parameter counts and against bounds worked out by hand at one small
shape."""

import json

import pytest

from portbench import costs
from portbench.costs import deepseek_v2, qwen2
from portbench.spec import PKG


def conf(name: str) -> dict:
    return json.loads((PKG / "configs" / f"{name}.json").read_text())


def test_qwen25_7b_counts_its_published_7_62b():
    p = qwen2.params(conf("qwen2.5-7b"))
    assert p["total"] == pytest.approx(7.62e9, rel=2e-3)
    # The layers alone: all but the embedding, the lm_head and the final norm.
    assert p["total"] - p["body_active"] == 2 * 152064 * 3584 + 3584


def test_qwen25_7b_layers_match_the_ports_dense_count():
    from opsagent_tpu_torch.models.config import get_config_preset

    cfg = get_config_preset("qwen2.5-7b-instruct")
    biases = 28 * (3584 + 2 * 512)
    assert qwen2.params(conf("qwen2.5-7b"))["total"] == cfg.num_params() + biases


def test_deepseek_v2_lite_counts_15_7b_total_and_2_4b_active():
    p = deepseek_v2.params(conf("deepseek-v2-lite"))
    assert p["total"] == pytest.approx(15.7e9, rel=5e-3)
    assert p["active"] == pytest.approx(2.4e9, rel=0.03)
    assert p["active"] - p["body_active"] == 102400 * 2048 + 2048


def test_kv_bytes_per_token():
    assert qwen2.kv_token_bytes(conf("qwen2.5-7b")) == 57_344
    assert deepseek_v2.kv_token_bytes(conf("deepseek-v2-lite")) == 31_104


def small_qwen() -> dict:
    return {"hidden_size": 256, "num_attention_heads": 4, "num_key_value_heads": 2,
            "intermediate_size": 512, "vocab_size": 1000, "num_hidden_layers": 2}


def test_ragged_bound_by_hand():
    # One mixed tick: a 64-token chunk after 192 cached tokens and one decode
    # row at context 100. Pairs: 64 * 192 + 64 * 65 / 2 + 100 = 14_468.
    hf = small_qwen()          # D = 64, 4 heads, 2 kv heads, 2 layers
    pairs = 64 * 192 + 64 * 65 // 2 + 100
    flops = qwen2.attn_flops(hf, pairs)
    assert flops == 2 * 4 * 4 * 64 * 14_468
    # Cached tokens read: 256 by the chunk's row, 100 by the decode row; 65
    # query tokens in, 65 outputs out.
    nbytes = qwen2.attn_bytes(hf, 65, 256 + 100)
    assert nbytes == 356 * (2 * 2 * 2 * 64 * 2) + 65 * 2 * (2 * 4 * 64 * 2)
    assert costs.bound_s(flops, nbytes) == max(flops / 989e12, nbytes / 3.35e12)


def test_decode_bound_by_hand():
    # A block of 4 steps for 2 rows starting at contexts 1000 and 3000: the
    # rows read 4 * 1000 + 10 and 4 * 3000 + 10 cached tokens.
    hf = conf("deepseek-v2-lite")
    kv = 4 * 1000 + 10 + 4 * 3000 + 10
    nbytes = deepseek_v2.attn_bytes(hf, 8, kv)
    assert nbytes == kv * 27 * 576 * 2 + 8 * 27 * 16 * (576 + 512) * 2
    flops = deepseek_v2.attn_flops(hf, kv)
    assert flops == 27 * 16 * (2 * 576 + 2 * 512) * kv
    assert costs.bound_s(flops, nbytes) == nbytes / 3.35e12   # bound by bytes
