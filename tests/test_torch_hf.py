"""The port's HF checkpoint path against the JAX package's and against HF's
own outputs, on the CPU.

The fixtures ``tests/fixtures/tiny-{llama,qwen2,qwen3,qwen3-moe}-hf`` were
written by the HuggingFace implementations with their last-position logits
and greedy continuation (``golden.npz``); ``tiny-deepseek-moe`` pins the
DeepSeek MoE names (``tiny-moe`` preset) the same way. The port's
``config_from_hf`` and ``load_checkpoint`` must give what the JAX
package's give (``params_from_jax`` of its tree, bit for bit), also for
DeepSeek-V2/V3 (MLA + MoE) configs and checkpoints synthesized here with
the JAX package's ``save_checkpoint``; its own safetensors reader the bytes
``safetensors`` reads; and the model HF's logits to 2e-4 (the JAX test's
tolerance) and greedy tokens exactly, under both paged backends.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file
from safetensors.torch import load_file as load_file_torch
from safetensors.torch import save_file as save_file_torch

from opsagent_tpu.models.config import config_from_hf as jax_config_from_hf
from opsagent_tpu.models.loader import load_checkpoint as jax_load_checkpoint
from opsagent_tpu_torch.models.config import config_from_hf, resolve_model
from opsagent_tpu_torch.models.convert import params_from_jax
from opsagent_tpu_torch.models.llama import Llama
from opsagent_tpu_torch.models.loader import CheckpointError, load_checkpoint, read_safetensors
from opsagent_tpu_torch.models.quant import quantize_params
from opsagent_tpu_torch.serving.engine import Engine, EngineConfig
from opsagent_tpu_torch.serving.sampler import SamplingParams

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
DENSE = ["tiny-llama-hf", "tiny-qwen2-hf", "tiny-qwen3-hf"]
# MoE fixtures and the configuration each is served with: its own
# config.json ("auto"), or a preset.
MOE_FIXTURES = {"tiny-qwen3-moe-hf": "auto", "tiny-deepseek-moe": "tiny-moe"}

# HF config.json fields of the DeepSeek generations (V2-Lite's and V3's
# published values; the dense DeepSeek-MoE's), cut to tiny widths.
DEEPSEEK_HF = {
    "deepseek": dict(
        model_type="deepseek", vocab_size=512, hidden_size=64, intermediate_size=128,
        num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=4,
        n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=2,
        moe_intermediate_size=32, first_k_dense_replace=1, moe_layer_freq=1,
        norm_topk_prob=False, scoring_func="softmax", rms_norm_eps=1e-6,
        rope_theta=10000.0, max_position_embeddings=2048, tie_word_embeddings=False,
    ),
    "deepseek_v2": dict(
        model_type="deepseek_v2", vocab_size=512, hidden_size=64, intermediate_size=128,
        num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=4,
        n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=2,
        moe_intermediate_size=32, first_k_dense_replace=1, moe_layer_freq=1,
        norm_topk_prob=False, scoring_func="softmax", topk_method="greedy",
        n_group=1, topk_group=1, routed_scaling_factor=1.0,
        q_lora_rank=None, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
        v_head_dim=16, rms_norm_eps=1e-6, rope_theta=10000.0,
        max_position_embeddings=2048, tie_word_embeddings=False,
        rope_scaling={"type": "yarn", "factor": 40, "original_max_position_embeddings": 64,
                      "beta_fast": 32, "beta_slow": 1, "mscale": 0.707,
                      "mscale_all_dim": 0.707},
    ),
    "deepseek_v3": dict(
        model_type="deepseek_v3", vocab_size=512, hidden_size=64, intermediate_size=128,
        num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=4,
        n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1,
        moe_intermediate_size=32, first_k_dense_replace=1, moe_layer_freq=1,
        norm_topk_prob=True, scoring_func="sigmoid", topk_method="noaux_tc",
        n_group=4, topk_group=2, routed_scaling_factor=2.5,
        q_lora_rank=24, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
        v_head_dim=16, rms_norm_eps=1e-6, rope_theta=10000.0,
        max_position_embeddings=2048, tie_word_embeddings=False,
        rope_scaling={"type": "yarn", "factor": 40, "original_max_position_embeddings": 64,
                      "beta_fast": 32, "beta_slow": 1, "mscale": 1.0, "mscale_all_dim": 1.0},
    ),
}


def _path(name):
    return os.path.join(FIXTURES, name)


def _golden(name):
    return np.load(os.path.join(_path(name), "golden.npz"))


@pytest.mark.parametrize("name", DENSE)
def test_config_from_hf_matches_jax(name):
    got = dataclasses.asdict(config_from_hf(_path(name)))
    want = dataclasses.asdict(jax_config_from_hf(_path(name)))
    assert got == want
    assert resolve_model("auto", _path(name)) == config_from_hf(_path(name))


def test_config_from_hf_refuses_what_it_does_not_serve(tmp_path):
    """The JAX package's refusals, with its exception type: an unknown
    model type, active sliding-window attention, interleaved dense and MoE
    layers, an unknown router scoring."""
    qwen2 = json.load(open(os.path.join(_path("tiny-qwen2-hf"), "config.json")))
    qwen3_moe = json.load(open(os.path.join(_path("tiny-qwen3-moe-hf"), "config.json")))
    cases = (
        (qwen2, {"model_type": "gpt2"}, "gpt2"),
        (qwen2, {"sliding_window": 512, "use_sliding_window": True}, "sliding-window"),
        (qwen3_moe, {"mlp_only_layers": [0]}, "mlp_only_layers"),
        (qwen3_moe, {"decoder_sparse_step": 2}, "decoder_sparse_step"),
        (DEEPSEEK_HF["deepseek_v2"], {"moe_layer_freq": 2}, "moe_layer_freq"),
        (DEEPSEEK_HF["deepseek_v3"], {"scoring_func": "softmax_plus"}, "scoring_func"),
    )
    for base, edit, match in cases:
        (tmp_path / "config.json").write_text(json.dumps({**base, **edit}))
        with pytest.raises(ValueError, match=match):
            config_from_hf(str(tmp_path))
        with pytest.raises(ValueError):
            jax_config_from_hf(str(tmp_path))
    # The DeepSeek MoE fixture's config.json names no HF model type (it is
    # served with the tiny-moe preset): both packages refuse it.
    for derive in (config_from_hf, jax_config_from_hf):
        with pytest.raises(ValueError, match="deepseek-moe"):
            derive(_path("tiny-deepseek-moe"))
    with pytest.raises(ValueError, match="--checkpoint"):
        resolve_model("auto")


@pytest.mark.parametrize("model_type", sorted(DEEPSEEK_HF))
def test_config_from_hf_serves_the_moe_and_mla_types_as_jax(tmp_path, model_type):
    """The four types that were refused before MoE and MLA were ported
    (qwen3_moe through its fixture, the DeepSeek generations through
    synthesized config.json files) derive JAX's configuration; V2/V3 serve
    from the latent cache."""
    (tmp_path / "config.json").write_text(json.dumps(DEEPSEEK_HF[model_type]))
    got = config_from_hf(str(tmp_path))
    assert dataclasses.asdict(got) == dataclasses.asdict(jax_config_from_hf(str(tmp_path)))
    assert got.moe is not None and got.moe_layer_start == 1
    assert (got.mla is not None and got.mla.latent_cache) == (model_type != "deepseek")
    assert resolve_model("auto", str(tmp_path)) == got
    moe = config_from_hf(_path("tiny-qwen3-moe-hf"))
    assert dataclasses.asdict(moe) == dataclasses.asdict(
        jax_config_from_hf(_path("tiny-qwen3-moe-hf")))
    assert moe.moe.num_experts == 4 and moe.qk_norm and moe.moe_layer_start == 0


@pytest.mark.parametrize("name", DENSE + ["tiny-qwen3-moe-hf"])
def test_safetensors_reader_is_bit_equal(name):
    path = os.path.join(_path(name), "model.safetensors")
    want = load_file(path)
    got = read_safetensors(path)
    assert sorted(got) == sorted(want)
    for key, a in want.items():
        assert got[key].dtype == torch.float32
        np.testing.assert_array_equal(got[key].numpy(), a)


def test_safetensors_reader_bf16_f16_and_refusals(tmp_path):
    gen = torch.Generator().manual_seed(0)
    tensors = {
        "a": torch.randn(3, 5, generator=gen).to(torch.bfloat16),
        "b": torch.randn(7, generator=gen).to(torch.float16),
        "c": torch.randn(2, 2, 2, generator=gen),
    }
    path = str(tmp_path / "m.safetensors")
    save_file_torch(tensors, path, metadata={"format": "pt"})
    got, want = read_safetensors(path), load_file_torch(path)
    for key in tensors:
        assert got[key].dtype == want[key].dtype and torch.equal(got[key], want[key])
    save_file_torch({"i": torch.arange(4, dtype=torch.int64)}, path)
    with pytest.raises(CheckpointError, match="I64"):
        read_safetensors(path)


@pytest.mark.parametrize("name", DENSE)
def test_load_checkpoint_matches_jax(name):
    cfg = config_from_hf(_path(name))
    got = load_checkpoint(_path(name), cfg, torch.float32, device="cpu")
    tree = jax_load_checkpoint(_path(name), jax_config_from_hf(_path(name)), jnp.float32)
    want = params_from_jax(tree, cfg)
    assert sorted(got) == sorted(want)
    for key, t in want.items():
        assert got[key].is_contiguous()
        assert torch.equal(got[key], t), key


def _fixture_cfgs(name):
    """(port config, JAX config) a MoE fixture is served with."""
    from opsagent_tpu.models.config import get_config_preset as jax_preset
    from opsagent_tpu_torch.models.config import get_config_preset

    how = MOE_FIXTURES[name]
    if how == "auto":
        return config_from_hf(_path(name)), jax_config_from_hf(_path(name))
    return get_config_preset(how), jax_preset(how)


@pytest.mark.parametrize("name", sorted(MOE_FIXTURES))
def test_load_checkpoint_matches_jax_for_moe_fixtures(name):
    cfg, jcfg = _fixture_cfgs(name)
    got = load_checkpoint(_path(name), cfg, torch.float32, device="cpu")
    want = params_from_jax(jax_load_checkpoint(_path(name), jcfg, jnp.float32), cfg)
    assert sorted(got) == sorted(want)
    for key, t in want.items():
        assert got[key].is_contiguous() and torch.equal(got[key], t), key
    # The router stays f32 under a bf16 load.
    bf16 = load_checkpoint(_path(name), cfg, torch.bfloat16, device="cpu")
    first = cfg.moe_layer_start
    assert bf16[f"layers.{first}.router"].dtype == torch.float32
    assert bf16[f"layers.{first}.eg"].dtype == torch.bfloat16


def _synthesized_deepseek(tmp_path, model_type):
    """A DeepSeek-V2/V3 checkpoint directory: config.json and the JAX
    package's init_params written by its save_checkpoint (HF names:
    kv_a_proj_with_mqa, interleaved rope columns, o_proj over v_head_dim,
    e_score_correction_bias, experts)."""
    import jax

    from opsagent_tpu.models import llama as jllama
    from opsagent_tpu.models.loader import save_checkpoint

    (tmp_path / "config.json").write_text(json.dumps(DEEPSEEK_HF[model_type]))
    jcfg = jax_config_from_hf(str(tmp_path))
    params = jllama.init_params(jcfg, jax.random.PRNGKey(4), dtype=jnp.float32)
    if "router_bias" in params["moe_layers"]:
        params["moe_layers"]["router_bias"] = jnp.asarray(
            np.linspace(-0.1, 0.1, 16).reshape(2, 8), jnp.float32)
    save_checkpoint(str(tmp_path / "model.safetensors"), params, cfg=jcfg)
    return config_from_hf(str(tmp_path)), jcfg


@pytest.mark.parametrize("model_type", ["deepseek_v2", "deepseek_v3"])
def test_load_checkpoint_matches_jax_for_deepseek_mla(tmp_path, model_type):
    """The rope de-interleave, the kv_a split, the padded o_proj, the
    experts and the selection bias load as JAX's loader lays them out,
    quantized too; the loaded model's logits equal JAX's on that tree."""
    cfg, jcfg = _synthesized_deepseek(tmp_path, model_type)
    path = str(tmp_path)
    tree = jax_load_checkpoint(path, jcfg, jnp.float32)
    got = load_checkpoint(path, cfg, torch.float32, device="cpu")
    want = params_from_jax(tree, cfg)
    assert sorted(got) == sorted(want)
    for key, t in want.items():
        assert torch.equal(got[key], t), key
    quant = load_checkpoint(path, cfg, torch.float32, device="cpu", quantize="int4")
    want_q = quantize_params(got, "int4")
    assert sorted(quant) == sorted(want_q) and all(torch.equal(quant[k], want_q[k]) for k in want_q)
    from opsagent_tpu.models import llama as jllama

    model = Llama(cfg, torch.float32, "cpu", seed=None)
    model.load_state_dict(got)
    tokens = np.array([[5, 6, 7, 8, 9, 10, 11]], np.int32)
    np.testing.assert_allclose(
        model.forward_full(torch.from_numpy(tokens).long()).numpy(),
        np.asarray(jllama.forward_full(tree, jcfg, tokens, dtype=jnp.float32)),
        rtol=1e-4, atol=1e-4,
    )


def test_load_checkpoint_tied_quantized_and_errors(tmp_path):
    """A tied config ignores lm_head.weight and builds no lm_head; with
    quantize the state is quantize_params of the unquantized one; a
    missing head without tying, a missing tensor and a wrong vocab raise."""
    path = _path("tiny-qwen2-hf")
    cfg = config_from_hf(path)
    tied = load_checkpoint(path, dataclasses.replace(cfg, tie_embeddings=True),
                           torch.float32, device="cpu")
    assert "lm_head" not in tied
    full = load_checkpoint(path, cfg, torch.float32, device="cpu")
    quant = load_checkpoint(path, cfg, torch.float32, device="cpu", quantize="int8")
    want = quantize_params(full, "int8")
    assert sorted(quant) == sorted(want)
    assert all(torch.equal(quant[k], want[k]) for k in want)
    model = Llama(cfg, torch.float32, "cpu", seed=None, quantize="int8")
    model.load_state_dict(quant)

    tensors = load_file(os.path.join(path, "model.safetensors"))
    from safetensors.numpy import save_file

    def write(drop):
        save_file({k: v for k, v in tensors.items() if k != drop},
                  str(tmp_path / "model.safetensors"))

    write("lm_head.weight")
    with pytest.raises(CheckpointError, match="lm_head"):
        load_checkpoint(str(tmp_path), cfg, torch.float32, device="cpu")
    write("model.layers.1.self_attn.q_proj.bias")
    with pytest.raises(CheckpointError, match="q_proj.bias"):
        load_checkpoint(str(tmp_path), cfg, torch.float32, device="cpu")
    with pytest.raises(CheckpointError, match="embed shape"):
        load_checkpoint(path, dataclasses.replace(cfg, vocab_size=600), torch.float32,
                        device="cpu")


def test_load_checkpoint_from_index_shards(tmp_path):
    """Two shards named by model.safetensors.index.json load as one."""
    path = _path("tiny-llama-hf")
    tensors = load_file(os.path.join(path, "model.safetensors"))
    from safetensors.numpy import save_file

    names = sorted(tensors)
    shards = {"model-00001-of-00002.safetensors": names[: len(names) // 2],
              "model-00002-of-00002.safetensors": names[len(names) // 2:]}
    for file, keys in shards.items():
        save_file({k: tensors[k] for k in keys}, str(tmp_path / file))
    (tmp_path / "model.safetensors.index.json").write_text(json.dumps(
        {"weight_map": {k: f for f, keys in shards.items() for k in keys}}))
    cfg = config_from_hf(path)
    got = load_checkpoint(str(tmp_path), cfg, torch.float32, device="cpu")
    want = load_checkpoint(path, cfg, torch.float32, device="cpu")
    assert all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("name", DENSE)
def test_forward_matches_golden_logits(name):
    cfg = config_from_hf(_path(name))
    model = Llama(cfg, torch.float32, "cpu", seed=None)
    model.load_state_dict(load_checkpoint(_path(name), cfg, torch.float32, device="cpu"))
    golden = _golden(name)
    prompt = torch.from_numpy(golden["prompt"].astype(np.int64))[None]
    logits = model.forward_full(prompt)[0, -1].numpy()
    np.testing.assert_allclose(logits, golden["last_logits"], rtol=2e-4, atol=2e-4)
    # The same prompt as one mixed step through the paged cache.
    n = prompt.shape[1]
    cache = model.make_cache(8, 4)
    table = torch.arange(8, dtype=torch.int32)[None]
    step = model.mixed_step(prompt, torch.zeros(1, dtype=torch.int32),
                            torch.tensor([n], dtype=torch.int32), cache, table,
                            backend="grid")
    np.testing.assert_allclose(step[0].numpy(), golden["last_logits"], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("backend", ["dma", "grid"])
@pytest.mark.parametrize("name", DENSE)
def test_engine_generate_matches_golden_greedy(name, backend):
    """Checkpoint directory -> --model-name auto -> loader -> mixed-step
    prefill -> block decode reproduces HF's greedy continuation."""
    golden = _golden(name)
    eng = Engine(EngineConfig(
        model="auto", checkpoint=_path(name), dtype=torch.float32, device="cpu",
        page_size=4, num_pages=64, max_pages_per_seq=16, max_batch_size=2,
        decode_block=4, paged_backend=backend,
    ))
    assert eng.model_cfg == config_from_hf(_path(name))
    assert eng.impl_info()["paged_backend"] == backend
    want = golden["greedy"].tolist()
    got = eng.generate([golden["prompt"].tolist()], SamplingParams(max_tokens=len(want)))[0]
    assert got == want


@pytest.mark.parametrize("backend", ["dma", "grid"])
@pytest.mark.parametrize("name", sorted(MOE_FIXTURES))
def test_moe_fixture_matches_golden(name, backend):
    """The MoE fixtures through the port's loader: forward_full's and one
    mixed step's last-position logits within 2e-4 of golden.npz, and the
    engine's greedy continuation token for token."""
    cfg, _ = _fixture_cfgs(name)
    golden = _golden(name)
    model = Llama(cfg, torch.float32, "cpu", seed=None)
    model.load_state_dict(load_checkpoint(_path(name), cfg, torch.float32, device="cpu"))
    prompt = torch.from_numpy(golden["prompt"].astype(np.int64))[None]
    np.testing.assert_allclose(model.forward_full(prompt)[0, -1].numpy(),
                               golden["last_logits"], rtol=2e-4, atol=2e-4)
    n = prompt.shape[1]
    step = model.mixed_step(prompt, torch.zeros(1, dtype=torch.int32),
                            torch.tensor([n], dtype=torch.int32), model.make_cache(8, 4),
                            torch.arange(8, dtype=torch.int32)[None], backend=backend)
    np.testing.assert_allclose(step[0].numpy(), golden["last_logits"], rtol=2e-4, atol=2e-4)
    how = MOE_FIXTURES[name]
    eng = Engine(EngineConfig(
        model=how, checkpoint=_path(name), dtype=torch.float32, device="cpu",
        page_size=4, num_pages=64, max_pages_per_seq=16, max_batch_size=2,
        decode_block=4, paged_backend=backend,
    ), model_cfg=None if how == "auto" else cfg)
    want = golden["greedy"].tolist()
    got = eng.generate([golden["prompt"].tolist()], SamplingParams(max_tokens=len(want)))[0]
    assert got == want


def test_engine_rejects_unknown_backend():
    with pytest.raises(ValueError, match="paged_backend='pallas'"):
        Engine(EngineConfig(device="cpu", num_pages=8, paged_backend="pallas"))


PROBE = """
import sys
from opsagent_tpu_torch.models.config import config_from_hf
from opsagent_tpu_torch.models.loader import load_checkpoint
path = sys.argv[1]
state = load_checkpoint(path, config_from_hf(path), device="cpu")
print(len(state), sorted(m for m in sys.modules if m.split(".")[0] in
      ("safetensors", "jax", "opsagent_tpu")))
"""


def test_loader_never_imports_safetensors():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c", PROBE, _path("tiny-qwen3-hf")], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.split(" ", 1)[1].strip() == "[]"
