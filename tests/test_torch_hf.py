"""The port's HF checkpoint path against the JAX package's and against HF's
own outputs, on the CPU.

The fixtures ``tests/fixtures/tiny-{llama,qwen2,qwen3}-hf`` were written by
the HuggingFace implementations with their last-position logits and greedy
continuation (``golden.npz``). The port's ``config_from_hf`` and
``load_checkpoint`` must give what the JAX package's give
(``params_from_jax`` of its tree, bit for bit), its own safetensors reader
the bytes ``safetensors`` reads, and the model HF's logits to 2e-4 (the JAX
test's tolerance) and greedy tokens exactly, under both paged backends.
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
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        config_from_hf(_path("tiny-qwen3-moe-hf"))
    hf = json.load(open(os.path.join(_path("tiny-qwen2-hf"), "config.json")))
    for edit, error in (({"model_type": "gpt2"}, ValueError),
                        ({"model_type": "deepseek_v3"}, NotImplementedError),
                        ({"sliding_window": 512, "use_sliding_window": True}, ValueError)):
        (tmp_path / "config.json").write_text(json.dumps({**hf, **edit}))
        with pytest.raises(error):
            config_from_hf(str(tmp_path))
    with pytest.raises(ValueError, match="--checkpoint"):
        resolve_model("auto")


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
