"""The port's multi-head latent attention against the JAX package's, on the
CPU.

Same weights (the JAX package's ``init_params`` carried across with
``params_from_jax``) and the same inputs, made from a numpy seed:

- the MLA pieces: ``mla_latent_parts`` / ``mla_latent_out`` /
  ``qkv_mla`` against JAX's ``_mla_latent_parts`` / ``_mla_latent_out`` /
  ``_qkv_mla`` at ``tiny-mla`` (low-rank q) and at a full-rank-q cut with
  YaRN (V2-Lite's form), to 1e-5 in f32;
- the plain paged attention at the latent shape (D = 576, one kv head, the
  same pages as k and v) against JAX's ``paged_ragged_attention`` /
  ``paged_decode_attention`` and its Pallas dma kernels in interpret mode,
  to 1e-5;
- the steps (``forward_full``, ``mixed_step``, ``decode_step``) at
  ``tiny-mla`` with the latent cache and without it, and at a V3-shaped
  tiny MoE + MLA config (sigmoid router, groups, low-rank q, latent
  cache), in f32 (logits and caches to 1e-4) and with int8 and int4
  weights (JAX's ``weight_stream="pallas-dma"`` in interpret mode; 1e-3),
  and in bf16 (logits to 0.05, caches to one bf16 rounding of |x| <= 8);
- the engine: greedy tokens equal to the JAX engine's at latent
  ``tiny-mla`` with a prefix hit; warmup; the JAX refusals.
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opsagent_tpu.models import config as jconfig
from opsagent_tpu.models import llama as jllama
from opsagent_tpu.models.quant import quantize_params
from opsagent_tpu.ops.attention import paged_decode_attention as jax_decode
from opsagent_tpu.ops.attention import paged_ragged_attention as jax_ragged
from opsagent_tpu.ops.paged_attention_pallas import (
    paged_decode_attention_pallas_dma,
    paged_ragged_attention_pallas_dma,
)
from opsagent_tpu.ops.rope import rope_table as jax_rope_table
from opsagent_tpu.serving.engine import Engine as JaxEngine
from opsagent_tpu.serving.engine import EngineConfig as JaxEngineConfig
from opsagent_tpu.serving.sampler import SamplingParams as JaxSamplingParams
from opsagent_tpu_torch.models import config as tconfig
from opsagent_tpu_torch.models.convert import params_from_jax
from opsagent_tpu_torch.models.llama import Llama
from opsagent_tpu_torch.ops import attention as tattn
from opsagent_tpu_torch.ops.paged_attention import (
    LATENT_DIM,
    paged_decode_attention_cuda,
    paged_ragged_attention_cuda,
)
from opsagent_tpu_torch.ops.rope import rope_table
from opsagent_tpu_torch.serving.engine import Engine, EngineConfig
from opsagent_tpu_torch.serving.sampler import SamplingParams
from test_torch_engine import MAX_TOKENS, SHAPE, drive
from test_torch_moe import warmup_leaves_pages_allocator_and_tokens

TOL = 1e-5
STEP_TOL = 1e-4
QUANT_TOL = 1e-3
BF16_LOGIT_TOL = 5e-2
PAGE, PAGES, MAXP = 4, 32, 8


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _latent(cfg, on=True):
    return dataclasses.replace(cfg, mla=dataclasses.replace(cfg.mla, latent_cache=on))


def _pair(name, latent=True):
    """(JAX config, port config) of one test configuration."""
    if name == "tiny-mla":
        return _latent(jconfig.TINY_MLA, latent), _latent(tconfig.TINY_MLA, latent)
    if name == "full-q-yarn":
        # V2-Lite's form at tiny widths: full-rank q, YaRN with mscale.
        out = []
        for c in (jconfig, tconfig):
            rs = c.RopeScalingConfig(rope_type="yarn", factor=40.0, original_max_position=64,
                                     mscale=0.707, mscale_all_dim=0.707)
            out.append(dataclasses.replace(
                _latent(c.TINY_MLA, latent), rope_scaling=rs,
                mla=dataclasses.replace(c.TINY_MLA.mla, q_lora_rank=0, latent_cache=latent),
            ))
        return tuple(out)
    assert name == "v3-tiny"
    out = []
    for c in (jconfig, tconfig):
        moe = c.MoEConfig(num_experts=8, num_experts_per_token=2, num_shared_experts=1,
                          expert_intermediate_size=32, norm_topk_prob=True,
                          routed_scaling_factor=2.5, scoring_func="sigmoid", n_group=4,
                          topk_group=2, grouped_dispatch_min_tokens=0)
        out.append(dataclasses.replace(_latent(c.TINY_MLA, latent), moe=moe, moe_layer_start=1))
    return tuple(out)


def _params(jcfg, mode="", dtype=jnp.float32, seed=0):
    params = jllama.init_params(jcfg, jax.random.PRNGKey(seed), dtype=dtype)
    if "moe_layers" in params and "router_bias" in params["moe_layers"]:
        params["moe_layers"]["router_bias"] = 0.05 * jax.random.normal(
            jax.random.PRNGKey(seed + 7), params["moe_layers"]["router_bias"].shape
        )
    return quantize_params(params, mode) if mode else params


def _port(params, tcfg, mode="", dtype=torch.float32):
    model = Llama(tcfg, dtype, "cpu", seed=None, quantize=mode)
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.float32)) if a.dtype ==
                               jnp.bfloat16 else np.asarray(a), params), tcfg
    ))
    return model


@pytest.mark.parametrize("latent", [True, False])
@pytest.mark.parametrize("name", ["tiny-mla", "full-q-yarn"])
def test_mla_pieces_match_jax(name, latent):
    jcfg, tcfg = _pair(name, latent)
    params = _params(jcfg)
    model = _port(params, tcfg)
    layer = model.layers[0]
    lp = jax.tree_util.tree_map(lambda a: a[0], params["layers"])
    rng = np.random.default_rng(5)
    B, S = 2, 6
    h = rng.standard_normal((B, S, jcfg.hidden_size)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4, 5], [7, 8, 9, 10, 11, 12]], np.int32)
    jcos, jsin = jax_rope_table(jnp.asarray(pos), jcfg.rope_dim_, jcfg.rope_theta,
                                scaling=jcfg.rope_scaling)
    cos, sin = rope_table(_t(pos), tcfg.rope_dim_, tcfg.rope_theta, tcfg.rope_scaling)
    assert tcfg.rope_dim_ == jcfg.rope_dim_ == jcfg.mla.qk_rope_head_dim
    want = jllama._mla_latent_parts(jnp.asarray(h), lp, jcfg, jcos, jsin)
    got = layer.mla_latent_parts(_t(h), tcfg, cos, sin)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)
    ctx = rng.standard_normal((B, S, jcfg.num_heads, jcfg.mla.latent_dim)).astype(np.float32)
    np.testing.assert_allclose(
        layer.mla_latent_out(_t(ctx), tcfg).numpy(),
        np.asarray(jllama._mla_latent_out(jnp.asarray(ctx), lp, jcfg)), rtol=TOL, atol=TOL,
    )
    want = jllama._qkv_mla(jnp.asarray(h), lp, jcfg, jcos, jsin)
    got = layer.qkv_mla(_t(h), tcfg, cos, sin)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)


def _latent_case(seed, H, B=3, S=5):
    """Latent pages [L, N, P, 1, 576]: row 0 a chunk from mid-page, row 1
    inactive, row 2 three rows; then the decode lengths."""
    rng = np.random.default_rng(seed)
    start = np.array([5, 0, 9], np.int32)[:B]
    q_lens = np.array([S, 0, 3], np.int32)[:B]
    N, L = 24, 2
    table = np.full((B, MAXP), -1, np.int32)
    free = list(rng.permutation(N))
    for b in range(B):
        for i in range(-(-(start[b] + q_lens[b]) // PAGE)):
            table[b, i] = free.pop()
    return dict(
        q=rng.standard_normal((B, S, H, LATENT_DIM)).astype(np.float32),
        pages=rng.standard_normal((L, N, PAGE, 1, LATENT_DIM)).astype(np.float32),
        table=table, start=start, q_lens=q_lens, lengths=(start + q_lens).astype(np.int32),
    )


@pytest.mark.parametrize("H", [4, 16])
def test_latent_ragged_plain_matches_jax_and_pallas_dma(H):
    c = _latent_case(0, H)
    valid = np.arange(c["q"].shape[1])[None, :] < c["q_lens"][:, None]
    args = (c["table"], c["start"], c["q_lens"])
    got = tattn.paged_ragged_attention(
        _t(c["q"]), _t(c["pages"]), _t(c["pages"]), *map(_t, args), layer=1
    ).numpy()
    want = np.asarray(jax_ragged(c["q"], c["pages"], c["pages"], *args, layer=jnp.int32(1)))
    np.testing.assert_allclose(got[valid], want[valid], rtol=TOL, atol=TOL)
    kernel = np.asarray(paged_ragged_attention_pallas_dma(
        c["q"], c["pages"], c["pages"], *args, interpret=True, layer=jnp.int32(1)
    ))
    np.testing.assert_allclose(got[valid], kernel[valid], rtol=TOL, atol=TOL)
    assert np.all(got[~valid] == 0)
    # The wrapper takes the plain version for CPU tensors.
    wrapped = paged_ragged_attention_cuda(
        _t(c["q"]), _t(c["pages"]), _t(c["pages"]), *map(_t, args), layer=1
    ).numpy()
    np.testing.assert_array_equal(wrapped, got)


@pytest.mark.parametrize("H", [4, 16])
def test_latent_decode_plain_matches_jax_and_pallas_dma(H):
    c = _latent_case(1, H)
    q = c["q"][:, 0]
    live = c["lengths"] > 0
    args = (c["table"], c["lengths"])
    got = tattn.paged_decode_attention(
        _t(q), _t(c["pages"]), _t(c["pages"]), *map(_t, args), layer=0
    ).numpy()
    want = np.asarray(jax_decode(q, c["pages"], c["pages"], *args, layer=jnp.int32(0)))
    np.testing.assert_allclose(got[live], want[live], rtol=TOL, atol=TOL)
    kernel = np.asarray(paged_decode_attention_pallas_dma(
        q, c["pages"], c["pages"], *args, interpret=True, layer=jnp.int32(0)
    ))
    np.testing.assert_allclose(got[live], kernel[live], rtol=TOL, atol=TOL)
    wrapped = paged_decode_attention_cuda(
        _t(q), _t(c["pages"]), _t(c["pages"]), *map(_t, args), layer=0
    ).numpy()
    np.testing.assert_array_equal(wrapped, got)


# (S, starts, q_lens, pages, table width) of the materialized cases: row 0
# a chunk from mid-page, row 1 inactive, row 2 three rows; "long" adds a
# chunk of 70 rows (past a 64-row tile) at a context of 200 (past the
# runs the warpgroup kernel's plan cuts), the shape of its cut tiles.
MATERIALIZED = {
    "short": (5, [2, 0, 9], [5, 0, 3], PAGES, MAXP),
    "long": (70, [130, 0, 9], [70, 0, 3], 64, 56),
}


def _materialized_case(seed, D, H=4, shape="short"):
    """Materialized MLA pages [L, N, P, H, D] (a kv head per query head), v
    zero past two thirds of the columns as the model pads it (rows from
    ``MATERIALIZED``); the decode lengths."""
    rng = np.random.default_rng(seed)
    S, starts, lens, N, maxp = MATERIALIZED[shape]
    L, B = 2, len(starts)
    start = np.array(starts, np.int32)
    q_lens = np.array(lens, np.int32)
    table = np.full((B, maxp), -1, np.int32)
    free = list(rng.permutation(N))
    for b in range(B):
        for i in range(-(-(start[b] + q_lens[b]) // PAGE)):
            table[b, i] = free.pop()
    v = rng.standard_normal((L, N, PAGE, H, D)).astype(np.float32)
    v[..., 2 * D // 3:] = 0
    return dict(
        q=rng.standard_normal((B, S, H, D)).astype(np.float32),
        k=rng.standard_normal((L, N, PAGE, H, D)).astype(np.float32), v=v,
        table=table, start=start, q_lens=q_lens, lengths=(start + q_lens).astype(np.int32),
    )


@pytest.mark.parametrize("D,shape", [
    pytest.param(D, shape, id=str(D) if shape == "short" else f"{D}-{shape}")
    for shape in sorted(MATERIALIZED, reverse=True) for D in (24, 192)])
def test_materialized_head_dims_plain_matches_jax_and_pallas_dma(D, shape):
    """The function of the dma kernels' materialized-MLA instances (tiny-mla's
    24, V2/V3's 192): the plain version equals JAX's paged_ragged_attention
    / paged_decode_attention and its Pallas dma kernels in interpret mode,
    and the wrappers take it for CPU tensors."""
    c = _materialized_case(3, D, shape=shape)
    valid = np.arange(c["q"].shape[1])[None, :] < c["q_lens"][:, None]
    args = (c["table"], c["start"], c["q_lens"])
    got = tattn.paged_ragged_attention(
        _t(c["q"]), _t(c["k"]), _t(c["v"]), *map(_t, args), layer=1).numpy()
    want = np.asarray(jax_ragged(c["q"], c["k"], c["v"], *args, layer=jnp.int32(1)))
    np.testing.assert_allclose(got[valid], want[valid], rtol=TOL, atol=TOL)
    kernel = np.asarray(paged_ragged_attention_pallas_dma(
        c["q"], c["k"], c["v"], *args, interpret=True, layer=jnp.int32(1)))
    np.testing.assert_allclose(got[valid], kernel[valid], rtol=TOL, atol=TOL)
    assert np.all(got[~valid] == 0) and np.all(got[..., 2 * D // 3:] == 0)
    wrapped = paged_ragged_attention_cuda(
        _t(c["q"]), _t(c["k"]), _t(c["v"]), *map(_t, args), layer=1).numpy()
    np.testing.assert_array_equal(wrapped, got)

    q, live = c["q"][:, 0], c["lengths"] > 0
    dargs = (c["table"], c["lengths"])
    got = tattn.paged_decode_attention(
        _t(q), _t(c["k"]), _t(c["v"]), *map(_t, dargs), layer=0).numpy()
    want = np.asarray(jax_decode(q, c["k"], c["v"], *dargs, layer=jnp.int32(0)))
    np.testing.assert_allclose(got[live], want[live], rtol=TOL, atol=TOL)
    kernel = np.asarray(paged_decode_attention_pallas_dma(
        q, c["k"], c["v"], *dargs, interpret=True, layer=jnp.int32(0)))
    np.testing.assert_allclose(got[live], kernel[live], rtol=TOL, atol=TOL)
    wrapped = paged_decode_attention_cuda(
        _t(q), _t(c["k"]), _t(c["v"]), *map(_t, dargs), layer=0).numpy()
    np.testing.assert_array_equal(wrapped, got)


@pytest.mark.parametrize("D", [24, 192])
def test_materialized_head_dims_pass_the_dma_check_only(D):
    """The dma wrappers' check takes 24 and 192 with pages in q's dtype and
    counts their launches under ``*_mla``; int8 pages at those dims, and
    the grid wrappers' check, raise."""
    from opsagent_tpu_torch.ops import paged_attention as pa

    q = torch.zeros(2, 3, 4, D)
    pages = torch.zeros(8, 4, 4, D)
    ints = {"page_table": torch.zeros(2, 2, dtype=torch.int32),
            "start": torch.zeros(2, dtype=torch.int32)}
    pa._check(q, pages, pages, ints, 2, latent=True)
    with pytest.raises(ValueError, match="head dim"):
        pa._check(q, pages, pages, ints, 2)
    qp = tattn.QuantizedPages(torch.zeros(8, 4, 4, D, dtype=torch.int8), torch.ones(8, 4, 4))
    with pytest.raises(ValueError, match="materialized MLA"):
        pa._check(q, qp, qp, ints, 2, latent=True)
    before = dict(pa.LAUNCHES)
    pa._count("paged_ragged_attention", None, D)
    pa._count("paged_decode_attention", None, D)
    assert pa.LAUNCHES["paged_ragged_attention_mla"] == before["paged_ragged_attention_mla"] + 1
    assert pa.LAUNCHES["paged_decode_attention_mla"] == before["paged_decode_attention_mla"] + 1
    assert pa.LAUNCHES["paged_ragged_attention"] == before["paged_ragged_attention"]


def test_causal_prefill_takes_the_materialized_head_dims():
    """forward_full's oracle attention at MLA's materialized head dims
    (tiny-mla's 24, V2/V3's 192), against JAX's."""
    from opsagent_tpu.ops.attention import causal_prefill_attention as jax_prefill

    rng = np.random.default_rng(2)
    for D in (24, 192):
        q, k, v = (rng.standard_normal((2, 7, 4, D)).astype(np.float32) for _ in range(3))
        got = tattn.causal_prefill_attention(_t(q), _t(k), _t(v)).numpy()
        np.testing.assert_allclose(got, np.asarray(jax_prefill(q, k, v)), rtol=TOL, atol=TOL)


def _run_steps(name, latent, mode, dtype):
    """forward_full (f32), two mixed steps and a decode step through both
    packages: (port logits, JAX logits) of active rows per step and the two
    final caches."""
    jcfg, tcfg = _pair(name, latent)
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    params = _params(jcfg, mode, jdtype)
    model = _port(params, tcfg, mode, dtype)
    kernels = dict(dtype=jdtype)
    if mode:
        kernels["weight_stream"] = "pallas-dma"
        kernels["attn_impl"] = "pallas-dma"
    rng = np.random.default_rng(1)
    pairs = []
    if dtype == torch.float32 and not mode:
        tokens = rng.integers(0, 500, (2, 9)).astype(np.int32)
        want = jllama.forward_full(params, jcfg, tokens, dtype=jnp.float32)
        pairs.append((model.forward_full(_t(tokens).long()).numpy(), np.asarray(want)))
    B = 3
    table = np.full((B, MAXP), -1, np.int32)
    table[0, :4] = [7, 2, 9, 11]
    table[2, :4] = [4, 0, 13, 5]
    jcache = jllama.make_cache(jcfg, PAGES, PAGE, dtype=jdtype)
    tcache = model.make_cache(PAGES, PAGE)
    tokens = rng.integers(0, 500, (B, 16)).astype(np.int32)
    for start, q_lens in (([0, 0, 0], [10, 0, 5]), ([10, 0, 5], [1, 0, 6])):
        start, q_lens = np.array(start, np.int32), np.array(q_lens, np.int32)
        want, jcache = jllama.mixed_step(params, jcfg, tokens, start, q_lens, jcache, table,
                                         **kernels)
        got = model.mixed_step(_t(tokens).long(), _t(start), _t(q_lens), tcache, _t(table))
        ok = q_lens > 0
        pairs.append((got.numpy()[ok], np.asarray(want)[ok]))
    toks = np.array([17, 3, 99], np.int32)
    lengths = np.array([11, 0, 11], np.int32)
    active = np.array([True, False, True])
    want, jcache = jllama.decode_step(params, jcfg, toks, lengths, jcache, table, active,
                                      **kernels)
    got = model.decode_step(_t(toks).long(), _t(lengths), tcache, _t(table), _t(active))
    pairs.append((got.numpy()[active], np.asarray(want)[active]))
    caches = [(side.float().numpy(), np.asarray(jside.astype(jnp.float32)))
              for side, jside in ((tcache.k, jcache["k"]), (tcache.v, jcache["v"]))]
    return pairs, caches, tcache


@pytest.mark.parametrize("mode", ["", "int8", "int4"])
@pytest.mark.parametrize("name,latent", [("tiny-mla", True), ("tiny-mla", False),
                                         ("v3-tiny", True)])
def test_mla_steps_match_jax(name, latent, mode, monkeypatch):
    monkeypatch.setenv("OPSAGENT_PALLAS_INTERPRET", "1")
    pairs, caches, tcache = _run_steps(name, latent, mode, torch.float32)
    tol = QUANT_TOL if mode else STEP_TOL
    for got, want in pairs:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    for got, want in caches:
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    if latent:
        assert tcache.k.shape[-2] == 1 and tcache.v.shape[-2:] == (1, 1)
        assert not tcache.v.any()


@pytest.mark.parametrize("latent", [True, False])
def test_mla_steps_match_jax_in_bf16(latent):
    """bf16 weights and activations on both sides at tiny-mla: logits
    within 0.05 (two layers of bf16 rounding, summed in other orders),
    caches within one bf16 rounding of values up to 8. (A MoE router in
    bf16 may pick another expert at a near-tie, so the MoE configurations
    are held to JAX in f32.)"""
    pairs, caches, _ = _run_steps("tiny-mla", latent, "", torch.bfloat16)
    for got, want in pairs:
        np.testing.assert_allclose(got, want, rtol=BF16_LOGIT_TOL, atol=BF16_LOGIT_TOL)
    for got, want in caches:
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -5)


def _latent_engines(mode=""):
    jcfg, tcfg = _pair("tiny-mla", True)
    jeng = JaxEngine(JaxEngineConfig(
        model="tiny-mla", dtype=jnp.float32, tp=1, pipeline_depth=0, quantize=mode, **SHAPE,
    ), model_cfg=jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jeng.params)
    model = Llama(tcfg, torch.float32, "cpu", seed=None, quantize=mode)
    model.load_state_dict(params_from_jax(tree, tcfg))
    return jeng, model


@pytest.mark.parametrize("mode", ["", "int8"])
def test_latent_engine_greedy_tokens_match_jax_engine(mode):
    jeng, model = _latent_engines(mode)
    eng = Engine(EngineConfig(model="tiny-mla", dtype=torch.float32, device="cpu",
                              quantize=mode, **SHAPE), model=model)
    assert eng.cache.latent
    want = drive(jeng, JaxSamplingParams(max_tokens=MAX_TOKENS))
    got = drive(eng, SamplingParams(max_tokens=MAX_TOKENS))
    assert got == want
    assert eng.alloc.hit_tokens == jeng.alloc.hit_tokens > 0


def test_latent_engine_warmup_leaves_pages_allocator_and_tokens(monkeypatch):
    monkeypatch.setattr(tconfig, "PRESETS", {**tconfig.PRESETS,
                                             "tiny-mla-latent": _pair("tiny-mla")[1]})
    warmup_leaves_pages_allocator_and_tokens("tiny-mla-latent")


def test_mla_engine_refusals_and_backend(caplog):
    """As the JAX engine: kv_quantize is refused, a grid request serves on
    the one backend with the latent instances (dma), logged."""
    cfg = _pair("tiny-mla")[1]
    with pytest.raises(ValueError, match="kv_quantize is not supported for MLA"):
        Engine(EngineConfig(device="cpu", kv_quantize="int8", **SHAPE), model_cfg=cfg)
    with pytest.raises(ValueError, match="kv_quantize is not supported for MLA"):
        Llama(cfg, torch.float32, "cpu", seed=0).make_cache(8, 4, kv_quantize="int8")
    with caplog.at_level(logging.INFO, logger="opsagent_tpu_torch.engine"):
        eng = Engine(EngineConfig(device="cpu", paged_backend="grid", dtype=torch.float32,
                                  **SHAPE), model_cfg=cfg)
    assert eng.cfg.paged_backend == "dma" and eng.impl_info()["paged_backend"] == "dma"
    assert "forcing dma" in caplog.text
    with pytest.raises(ValueError, match="qk_head_dim"):
        Llama(dataclasses.replace(cfg, head_dim=32), torch.float32, "cpu")
    with pytest.raises(ValueError, match="no GQA"):
        Llama(dataclasses.replace(cfg, num_kv_heads=2), torch.float32, "cpu")


def test_v2_lite_preset_builds_at_tiny_depth_and_full_width_shapes():
    """deepseek-v2-lite: layer 0 dense, then MoE with 64 experts of 1408;
    MLA leaves at their published widths; the latent cache at 576. Built
    uninitialized at two layers and a 1,024-token vocabulary (no page of
    the ~1.2 GB is touched)."""
    cfg = dataclasses.replace(tconfig.get_config_preset("deepseek-v2-lite"), num_layers=2,
                              vocab_size=1024)
    model = Llama(cfg, torch.bfloat16, "cpu", seed=None)
    dense, moe = model.layers
    assert not dense.moe and moe.moe
    assert dense.wq.shape == (2048, 16 * 192) and dense.wo.shape == (16 * 192, 2048)
    assert dense.wdkv.shape == (2048, 512) and dense.wkr.shape == (2048, 64)
    assert dense.wukv.shape == (512, 16 * 256) and dense.wg.shape == (2048, 10944)
    assert moe.eg.shape == (64, 2048, 1408) and moe.ed.shape == (64, 1408, 2048)
    assert moe.sg.shape == (2048, 2816) and not hasattr(moe, "router_bias")
    cache = model.make_cache(4, 16)
    assert cache.k.shape == (2, 4, 16, 1, 576) and cache.v.shape == (2, 4, 16, 1, 1)
