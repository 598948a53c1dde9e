"""The port's mixture-of-experts layers against the JAX package's, on the CPU.

The same weights (the JAX package's ``init_params``, carried across with
``params_from_jax``) and the same hidden states, made from a numpy seed, go
through JAX's ``_moe_mlp`` in its all-experts form (the one its engine
serves with, ``grouped_dispatch_min_tokens=0``) and the port's
``DecoderLayer.moe_mlp``: softmax and sigmoid scoring, the sigmoid
router's selection bias, group-limited top-k under both scorings,
``norm_topk_prob``, routed scaling, shared experts. Output and balance
loss agree to 1e-5 in f32; with int8 and int4 experts the JAX side runs
``weight_stream_scope("pallas-dma")`` (``quant_matmul_pallas`` in
interpret mode, one 2-D expert slice a call), the port the plain version
of its quantized matmul, to 1e-5. Then the steps (``forward_full``,
``mixed_step``, ``decode_step``: logits to 1e-4, the caches to 1e-4) and
the engine (greedy tokens equal to the JAX engine's, with a prefix hit) at
``tiny-moe``, in f32 and with int8 and int4 weights.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opsagent_tpu.models import config as jconfig
from opsagent_tpu.models import llama as jllama
from opsagent_tpu.models.quant import quantize_params
from opsagent_tpu.serving.engine import Engine as JaxEngine
from opsagent_tpu.serving.engine import EngineConfig as JaxEngineConfig
from opsagent_tpu.serving.sampler import SamplingParams as JaxSamplingParams
from opsagent_tpu_torch.models import config as tconfig
from opsagent_tpu_torch.models.convert import params_from_jax
from opsagent_tpu_torch.models.llama import Llama
from opsagent_tpu_torch.models.quant import QuantizedLinear, QuantizedLinear4
from opsagent_tpu_torch.serving.engine import Engine, EngineConfig
from opsagent_tpu_torch.serving.sampler import SamplingParams
from test_torch_engine import MAX_TOKENS, SHAPE, drive

MLP_TOL = 1e-5
STEP_TOL = 1e-4
PAGE, PAGES, MAXP = 4, 32, 8

# Router variants over tiny-moe's widths (8 experts, so that 4 groups of 2
# can be cut down to 2).
VARIANTS = {
    "softmax": dict(),
    "softmax_norm_scaled": dict(norm_topk_prob=True, routed_scaling_factor=2.5),
    "softmax_groups": dict(n_group=4, topk_group=2),
    "sigmoid_bias": dict(scoring_func="sigmoid"),
    "sigmoid_groups_v3": dict(scoring_func="sigmoid", n_group=4, topk_group=2,
                              norm_topk_prob=True, routed_scaling_factor=2.5),
    "no_shared": dict(num_shared_experts=0),
}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _configs(**moe):
    """(JAX config, port config): tiny-moe with 8 experts and ``moe``."""
    base = dict(num_experts=8, num_experts_per_token=2, num_shared_experts=1,
                expert_intermediate_size=64, grouped_dispatch_min_tokens=0)
    base.update(moe)
    jcfg = dataclasses.replace(jconfig.TINY_MOE, moe=jconfig.MoEConfig(**base))
    tcfg = dataclasses.replace(tconfig.TINY_MOE, moe=tconfig.MoEConfig(**base))
    return jcfg, tcfg


def _params(jcfg, seed=0, mode="", dtype=jnp.float32):
    """JAX parameters (with a random selection bias for a sigmoid router)
    and the port's model over the same values."""
    params = jllama.init_params(jcfg, jax.random.PRNGKey(seed), dtype=dtype)
    moe_layers = params.get("moe_layers", {})
    if "router_bias" in moe_layers:
        moe_layers["router_bias"] = 0.05 * jax.random.normal(
            jax.random.PRNGKey(seed + 7), moe_layers["router_bias"].shape
        )
    if mode:
        params = quantize_params(params, mode)
    return params


def _port(params, tcfg, mode="", dtype=torch.float32):
    model = Llama(tcfg, dtype, "cpu", seed=None, quantize=mode)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a), params
    ), tcfg))
    return model


def _hidden(d, seed=3):
    return np.random.default_rng(seed).standard_normal((2, 7, d)).astype(np.float32)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_moe_mlp_matches_jax(variant):
    jcfg, tcfg = _configs(**VARIANTS[variant])
    params = _params(jcfg)
    model = _port(params, tcfg)
    layer = model.layers[tcfg.moe_layer_start]
    assert layer.moe and not model.layers[0].moe
    assert hasattr(layer, "router_bias") == (jcfg.moe.scoring_func == "sigmoid")
    assert layer.router.dtype == torch.float32
    lp = jax.tree_util.tree_map(lambda a: a[0], params["moe_layers"])
    h = _hidden(jcfg.hidden_size)
    want, want_aux = jllama._moe_mlp(jnp.asarray(h), lp, jcfg)
    got, aux = layer.moe_mlp(_t(h), tcfg, with_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MLP_TOL, atol=MLP_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=MLP_TOL, atol=MLP_TOL)
    assert layer.moe_mlp(_t(h), tcfg)[1] is None


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_moe_mlp_matches_jax_in_bf16(variant, monkeypatch):
    """bf16 weights and hidden states on both sides. JAX's ``silu`` on bf16
    rounds the sigmoid to bf16 before the product, torch's rounds once, so
    the outputs agree within 2**-4 (a few bf16 roundings of values up to
    about 4). With JAX's ``silu`` rounded once as torch's is, the rest
    (f32 router, the same top-k, the expert products, the weighted sum
    accumulated in bf16 one expert at a time in expert order) agrees bit
    for bit; a sum over the stacked experts in another order or in f32
    does not: top-4 of 8, so that a token sums at least three terms (a
    group-limited router keeps exactly four experts eligible)."""
    jcfg, tcfg = _configs(**VARIANTS[variant], num_experts_per_token=4)
    params = _params(jcfg, dtype=jnp.bfloat16)
    layer = _port(params, tcfg, dtype=torch.bfloat16).layers[tcfg.moe_layer_start]
    assert layer.eg.dtype == torch.bfloat16 and layer.router.dtype == torch.float32
    lp = jax.tree_util.tree_map(lambda a: a[0], params["moe_layers"])
    h = jnp.asarray(_hidden(jcfg.hidden_size)).astype(jnp.bfloat16)
    got, aux = layer.moe_mlp(_t(np.asarray(h.astype(jnp.float32))).bfloat16(), tcfg,
                             with_aux=True)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    want, want_aux = jllama._moe_mlp(h, lp, jcfg)
    np.testing.assert_allclose(got, np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -4, atol=2 ** -4)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=MLP_TOL, atol=MLP_TOL)
    monkeypatch.setattr(jax.nn, "silu", lambda x: (
        x.astype(jnp.float32) * jax.nn.sigmoid(x.astype(jnp.float32))).astype(x.dtype))
    want, _ = jllama._moe_mlp(h, lp, jcfg)
    np.testing.assert_array_equal(got, np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_experts_match_jax_kernel_path(mode, monkeypatch):
    """Each expert's 2-D slice through the quantized matmul: JAX's
    quant_matmul_pallas (interpret mode) against the port's plain
    version."""
    jcfg, tcfg = _configs(**VARIANTS["sigmoid_groups_v3"])
    params = _params(jcfg, mode=mode)
    model = _port(params, tcfg, mode)
    layer = model.layers[1]
    kind = QuantizedLinear4 if mode == "int4" else QuantizedLinear
    assert all(isinstance(getattr(layer, n), kind) for n in ("eg", "eu", "ed", "sg", "su", "sd"))
    assert layer.eg.shape == (8, 64, 64) and layer.router.dtype == torch.float32
    lp = jax.tree_util.tree_map(lambda a: a[0], params["moe_layers"])
    h = _hidden(jcfg.hidden_size, seed=4)
    monkeypatch.setenv("OPSAGENT_PALLAS_INTERPRET", "1")
    with jllama.weight_stream_scope("pallas-dma"):
        want, want_aux = jllama._moe_mlp(jnp.asarray(h), lp, jcfg)
    got, aux = layer.moe_mlp(_t(h), tcfg, with_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MLP_TOL, atol=MLP_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=MLP_TOL, atol=MLP_TOL)


def test_expert_codes_and_scales_equal_jax():
    """The stacked [E, In, Out] expert leaves quantize per expert slice to
    JAX's codes and scales; the router and the norms stay exact."""
    from opsagent_tpu_torch.models.quant import quantize_params as port_quantize

    jcfg, tcfg = _configs()
    params = _params(jcfg)
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg)
    for mode in ("int8", "int4"):
        got = port_quantize(state, mode)
        want = params_from_jax(
            jax.tree_util.tree_map(np.asarray, quantize_params(params, mode)), tcfg
        )
        assert sorted(got) == sorted(want)
        for key, t in want.items():
            assert torch.equal(got[key], t), (mode, key)
        assert "layers.1.router" in got and "layers.1.eg.q" in got
        assert "layers.1.mlp_norm.q" not in got


@pytest.mark.parametrize("mode", ["", "int8", "int4"])
def test_moe_steps_match_jax(mode, monkeypatch):
    """forward_full, two mixed steps (prefill chunks, an inactive row, then
    a decode row beside a continuing chunk) and a decode step with an
    inactive lane at tiny-moe: logits and the whole cache."""
    monkeypatch.setenv("OPSAGENT_PALLAS_INTERPRET", "1")
    jcfg, tcfg = jconfig.TINY_MOE, tconfig.TINY_MOE
    params = _params(jcfg, mode=mode)
    model = _port(params, tcfg, mode)
    kernels = dict(dtype=jnp.float32)
    if mode:
        kernels["weight_stream"] = "pallas-dma"
    tol = 1e-3 if mode else STEP_TOL
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 500, (2, 9)).astype(np.int32)
    if not mode:
        want = jllama.forward_full(params, jcfg, tokens, dtype=jnp.float32)
        got = model.forward_full(_t(tokens).long())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)
    B = 3
    table = np.full((B, MAXP), -1, np.int32)
    table[0, :4] = [7, 2, 9, 11]
    table[2, :4] = [4, 0, 13, 5]
    jcache = jllama.make_cache(jcfg, PAGES, PAGE, dtype=jnp.float32)
    tcache = model.make_cache(PAGES, PAGE)
    tokens = rng.integers(0, 500, (B, 16)).astype(np.int32)
    for start, q_lens in (([0, 0, 0], [10, 0, 5]), ([10, 0, 5], [1, 0, 6])):
        start, q_lens = np.array(start, np.int32), np.array(q_lens, np.int32)
        want, jcache = jllama.mixed_step(params, jcfg, tokens, start, q_lens, jcache, table,
                                         **kernels)
        got = model.mixed_step(_t(tokens).long(), _t(start), _t(q_lens), tcache, _t(table))
        ok = q_lens > 0
        np.testing.assert_allclose(got.numpy()[ok], np.asarray(want)[ok], rtol=tol, atol=tol)
    toks = np.array([17, 3, 99], np.int32)
    lengths = np.array([11, 0, 11], np.int32)
    active = np.array([True, False, True])
    want, jcache = jllama.decode_step(params, jcfg, toks, lengths, jcache, table, active,
                                      **kernels)
    got = model.decode_step(_t(toks).long(), _t(lengths), tcache, _t(table), _t(active))
    np.testing.assert_allclose(got.numpy()[active], np.asarray(want)[active], rtol=tol, atol=tol)
    for side, jside in ((tcache.k, jcache["k"]), (tcache.v, jcache["v"])):
        np.testing.assert_allclose(side.numpy(), np.asarray(jside), rtol=tol, atol=tol)


def test_forward_full_aux_is_the_sum_over_moe_layers():
    jcfg, tcfg = _configs(**VARIANTS["sigmoid_bias"])
    jcfg = dataclasses.replace(jcfg, num_layers=3)
    tcfg = dataclasses.replace(tcfg, num_layers=3)
    params = _params(jcfg)
    model = _port(params, tcfg)
    tokens = np.random.default_rng(2).integers(0, 500, (2, 6)).astype(np.int32)
    want, want_aux = jllama.forward_full(params, jcfg, tokens, dtype=jnp.float32,
                                         return_aux=True)
    got, aux = model.forward_full(_t(tokens).long(), return_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=STEP_TOL, atol=STEP_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=MLP_TOL, atol=MLP_TOL)
    dense = Llama(tconfig.TINY_TEST, torch.float32, "cpu", seed=0)
    assert float(dense.forward_full(_t(tokens).long() % 512, return_aux=True)[1]) == 0.0


@pytest.mark.parametrize("mode", ["", "int8"])
def test_engine_greedy_tokens_match_jax_engine(mode):
    """tiny-moe through both engines: admissions in mixed steps beside a
    decoding row, block decode, then a prompt that hits the first one's
    cached pages."""
    jeng = JaxEngine(JaxEngineConfig(
        model="tiny-moe", dtype=jnp.float32, tp=1, pipeline_depth=0, quantize=mode,
        **SHAPE,
    ))
    assert jeng.model_cfg.moe.grouped_dispatch_min_tokens == 0
    tree = jax.tree_util.tree_map(np.asarray, jeng.params)
    model = Llama(tconfig.TINY_MOE, torch.float32, "cpu", seed=None, quantize=mode)
    model.load_state_dict(params_from_jax(tree, tconfig.TINY_MOE))
    eng = Engine(EngineConfig(model="tiny-moe", dtype=torch.float32, device="cpu",
                              quantize=mode, **SHAPE), model=model)
    assert dataclasses.asdict(eng.model_cfg) == dataclasses.asdict(jeng.model_cfg)
    want = drive(jeng, JaxSamplingParams(max_tokens=MAX_TOKENS))
    got = drive(eng, SamplingParams(max_tokens=MAX_TOKENS))
    assert got == want
    assert eng.alloc.hit_tokens == jeng.alloc.hit_tokens > 0


def warmup_leaves_pages_allocator_and_tokens(model_name: str) -> None:
    """Warmup on an engine with two admitted prompts writes nothing into
    the cache's pages (its writes go to the scratch slot) and books no
    page; the next blocks give the tokens of an engine that never warmed
    up. Shared with test_torch_mla."""
    model = Llama(tconfig.get_config_preset(model_name), torch.float32, "cpu", seed=0)
    cfg = EngineConfig(model=model_name, dtype=torch.float32, device="cpu", **SHAPE)
    prompts = [[257] + list(range(40, 60)), [257, 9, 8, 7, 6, 5]]
    outs = []
    for warm in (True, False):
        eng = Engine(cfg, model=model)
        ids = [eng.add_request(p, SamplingParams(max_tokens=8)) for p in prompts]
        if warm:
            pages = [eng.cache.k.clone(), eng.cache.v.clone()]
            acct = eng.alloc.accounting()
            eng.warmup()
            assert torch.equal(pages[0], eng.cache.k) and torch.equal(pages[1], eng.cache.v)
            assert eng.alloc.accounting() == acct
        while any(not eng.sequences[i].done for i in ids):
            eng.step_block()
        outs.append([eng.finish(i) for i in ids])
    assert outs[0] == outs[1]


def test_engine_warmup_leaves_pages_allocator_and_tokens():
    warmup_leaves_pages_allocator_and_tokens("tiny-moe")


def test_random_init_builds_experts_on_the_device_fan_in_scaled():
    model = Llama(tconfig.TINY_MOE, torch.float32, "cpu", seed=5)
    layer = model.layers[1]
    assert layer.eg.shape == (4, 64, 64) and layer.ed.shape == (4, 64, 64)
    assert layer.sg.shape == (64, 64) and layer.router.shape == (64, 4)
    assert abs(layer.eg.std().item() - 64 ** -0.5) < 0.02
    assert torch.equal(layer.mlp_norm, torch.ones(64))
    q8 = Llama(tconfig.TINY_MOE, torch.float32, "cpu", seed=5, quantize="int8")
    assert q8.layers[1].eg.q.shape == (4, 64, 64) and q8.layers[1].eg.scale.shape == (4, 1, 64)
    q4 = Llama(tconfig.TINY_MOE, torch.float32, "cpu", seed=5, quantize="int4")
    assert q4.layers[1].eg.shape == (4, 64, 64) and q4.layers[1].eg.scale.shape == (4, 1, 1, 64)
    w = q4.layers[1].eg.dequantize()
    assert w.shape == (4, 64, 64) and abs(w.std().item() - 64 ** -0.5) < 0.02


@pytest.mark.parametrize("mode", ["", "int8", "int4"])
@pytest.mark.parametrize("name", ["tiny-moe", "tiny-mla", "moe-mla"])
def test_params_from_jax_round_trip(name, mode):
    """A JAX tree of each family, plain and quantized, carries into a
    model built with the same ``quantize`` (every leaf, strictly) and
    comes back out of its state dict unchanged."""
    if name == "moe-mla":
        jcfg, tcfg = _configs(**VARIANTS["sigmoid_groups_v3"])
        jcfg = dataclasses.replace(jconfig.TINY_MLA, moe=jcfg.moe, moe_layer_start=1)
        tcfg = dataclasses.replace(tconfig.TINY_MLA, moe=tcfg.moe, moe_layer_start=1)
    else:
        jcfg, tcfg = jconfig.get_config_preset(name), tconfig.get_config_preset(name)
    params = _params(jcfg, mode=mode)
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg)
    model = Llama(tcfg, torch.float32, "cpu", seed=None, quantize=mode)
    model.load_state_dict(state, strict=True)
    back = model.state_dict()
    assert sorted(back) == sorted(state)
    assert all(torch.equal(back[k], t) for k, t in state.items())
    with pytest.raises(ValueError, match="moe_layers"):
        params_from_jax({**params, "moe_layers": {}},
                        dataclasses.replace(tcfg, moe=None))
