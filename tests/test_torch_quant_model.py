"""The port's quantized serving path against the JAX package's, on the CPU.

``tiny-test`` in f32 with int8 or int4 weights and an int8 KV cache. The
JAX side runs its kernel path: ``weight_stream="pallas-dma"``
(``quant_matmul_pallas``) and the DMA attention kernels, in interpret mode
(``OPSAGENT_PALLAS_INTERPRET=1``); the port runs the plain versions of its
kernels, which is what its wrappers take for CPU tensors.

Tolerances: logits 1e-3 (f32 sums in another order through two quantized
layers); KV scales 1e-5 relative; KV codes may differ by 1 where an f32
value sits on a rounding boundary, in under 0.1 % of the entries.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opsagent_tpu.models import llama as jllama
from opsagent_tpu.models.config import TINY_TEST as JAX_TINY
from opsagent_tpu.models.quant import quantize_params
from opsagent_tpu.serving.engine import Engine as JaxEngine
from opsagent_tpu.serving.engine import EngineConfig as JaxEngineConfig
from opsagent_tpu.serving.sampler import SamplingParams as JaxSamplingParams
from opsagent_tpu_torch.models.config import TINY_TEST
from opsagent_tpu_torch.models.convert import params_from_jax
from opsagent_tpu_torch.models.llama import Llama
from opsagent_tpu_torch.models.quant import QuantizedLinear, QuantizedLinear4
from opsagent_tpu_torch.serving.engine import Engine, EngineConfig
from opsagent_tpu_torch.serving.sampler import SamplingParams
from test_torch_engine import MAX_TOKENS, SHAPE, drive

TOL = 1e-3
PAGE, PAGES, MAXP = 4, 32, 8


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _port_model(tree, mode):
    model = Llama(TINY_TEST, torch.float32, "cpu", seed=None, quantize=mode)
    model.load_state_dict(params_from_jax(tree, TINY_TEST))
    return model


def _assert_caches_agree(tcache, jcache):
    for side, jside in ((tcache.k, jcache["k"]), (tcache.v, jcache["v"])):
        np.testing.assert_allclose(
            side.scale.numpy(), np.asarray(jside.scale), rtol=1e-5, atol=0
        )
        diff = np.abs(side.q.numpy().astype(np.int32) - np.asarray(jside.q).astype(np.int32))
        assert diff.max() <= 1
        assert (diff > 0).mean() < 1e-3


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_mixed_and_decode_steps_match_jax(mode, monkeypatch):
    """Two mixed steps (prefill chunks, an inactive row, then a decode row
    beside a continuing chunk) and a decode step with an inactive lane,
    over int8 KV pages."""
    monkeypatch.setenv("OPSAGENT_PALLAS_INTERPRET", "1")
    params = quantize_params(
        jllama.init_params(JAX_TINY, jax.random.PRNGKey(0), dtype=jnp.float32), mode
    )
    model = _port_model(jax.tree_util.tree_map(np.asarray, params), mode)
    expected = QuantizedLinear4 if mode == "int4" else QuantizedLinear
    assert isinstance(model.layers[1].wd, expected) and isinstance(model.lm_head, expected)
    kernels = dict(dtype=jnp.float32, attn_impl="pallas-dma", weight_stream="pallas-dma")
    rng = np.random.default_rng(1)
    B = 3
    table = np.full((B, MAXP), -1, np.int32)
    table[0, :4] = [7, 2, 9, 11]
    table[2, :4] = [4, 0, 13, 5]
    jcache = jllama.make_cache(JAX_TINY, PAGES, PAGE, dtype=jnp.float32, kv_quantize="int8")
    tcache = model.make_cache(PAGES, PAGE, kv_quantize="int8")

    tokens = rng.integers(0, 263, (B, 16)).astype(np.int32)
    for start, q_lens in (([0, 0, 0], [10, 0, 5]), ([10, 0, 5], [1, 0, 6])):
        start, q_lens = np.array(start, np.int32), np.array(q_lens, np.int32)
        want, jcache = jllama.mixed_step(
            params, JAX_TINY, tokens, start, q_lens, jcache, table, **kernels
        )
        got = model.mixed_step(_t(tokens).long(), _t(start), _t(q_lens), tcache, _t(table))
        ok = q_lens > 0
        np.testing.assert_allclose(got.numpy()[ok], np.asarray(want)[ok], rtol=TOL, atol=TOL)
    _assert_caches_agree(tcache, jcache)

    toks = np.array([17, 3, 99], np.int32)
    lengths = np.array([11, 0, 11], np.int32)
    active = np.array([True, False, True])
    want, jcache = jllama.decode_step(
        params, JAX_TINY, toks, lengths, jcache, table, active, **kernels
    )
    got = model.decode_step(_t(toks).long(), _t(lengths), tcache, _t(table), _t(active))
    np.testing.assert_allclose(got.numpy()[active], np.asarray(want)[active], rtol=TOL, atol=TOL)
    _assert_caches_agree(tcache, jcache)


def test_quantized_engine_greedy_tokens_match_jax_engine(monkeypatch):
    """int8 weights (random, built by the JAX engine on its device) and int8
    KV: the port engine gives the JAX engine's greedy tokens, prefix-cache
    hit included."""
    monkeypatch.setenv("OPSAGENT_PALLAS_INTERPRET", "1")
    quant = dict(quantize="int8", kv_quantize="int8")
    jeng = JaxEngine(JaxEngineConfig(
        model="tiny-test", dtype=jnp.float32, tp=1, pipeline_depth=0,
        weight_stream="pallas-dma", **quant, **SHAPE,
    ))
    assert jeng.impl_info()["weight_stream"] == "pallas-dma"
    want = drive(jeng, JaxSamplingParams(max_tokens=MAX_TOKENS))
    model = _port_model(jax.tree_util.tree_map(np.asarray, jeng.params), "int8")
    eng = Engine(
        EngineConfig(model="tiny-test", dtype=torch.float32, device="cpu", **quant, **SHAPE),
        model=model,
    )
    assert drive(eng, SamplingParams(max_tokens=MAX_TOKENS)) == want
    assert eng.alloc.hit_tokens == jeng.alloc.hit_tokens > 0
    info = eng.impl_info()
    assert (info["quantize"], info["kv_quantize"]) == ("int8", "int8")


def test_engine_rejects_unsupported_quantization():
    cpu = dict(model="tiny-test", dtype=torch.float32, device="cpu", num_pages=8)
    with pytest.raises(ValueError, match="quantize='int2'"):
        Engine(EngineConfig(quantize="int2", **cpu))
    with pytest.raises(ValueError, match="only 'int8'"):
        Engine(EngineConfig(kv_quantize="int4", **cpu))
    model = Llama(TINY_TEST, torch.float32, "cpu", seed=0)
    with pytest.raises(ValueError, match="unquantized"):
        Engine(EngineConfig(quantize="int8", **cpu), model=model)


@pytest.mark.parametrize("mode,top", [("int8", 127), ("int4", 7)])
def test_random_quantized_init_is_fan_in_scaled(mode, top):
    """Random weights are built directly in quantized form: codes uniform
    in [-top, top], one scale per tensor, dequantized std near fan_in^-1/2."""
    model = Llama(TINY_TEST, torch.float32, "cpu", seed=3, quantize=mode)
    d, f = TINY_TEST.hidden_size, TINY_TEST.intermediate_size
    for w, fan_in in ((model.layers[0].wg, d), (model.layers[1].wd, f), (model.lm_head, d)):
        deq = w.dequantize()
        assert tuple(deq.shape) == tuple(w.shape)
        assert deq.abs().max() <= top * w.scale.max() + 1e-6
        assert torch.unique(w.scale).numel() == 1
        assert abs(deq.std().item() - fan_in ** -0.5) < 0.15 * fan_in ** -0.5
    assert torch.equal(model.final_norm, torch.ones(d))
