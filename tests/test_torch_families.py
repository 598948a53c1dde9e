"""The port's Qwen-family and long-context model features against the JAX
package's, on the CPU.

Each variant of ``tiny-test`` (Qwen2's q/k/v biases, Qwen3's per-head q/k
RMSNorm with an explicit head dim, tied embeddings, llama3 and YaRN rope
scaling) gets the JAX package's ``init_params`` weights with the biases and
q/k norm weights redrawn from a numpy seed (the init leaves them at 0 and
1, which would test nothing), carried across with ``params_from_jax``. The
JAX side runs its grid kernels (``attn_impl="pallas"``, interpret mode);
the port runs its "grid" backend, whose wrappers take the plain versions
for CPU tensors. Tolerances: rope frequencies one f32 ulp, tables 1e-6;
logits and KV caches 1e-4 in f32 (sums in another order through two
layers); 1e-3 with int8 weights and int8 KV.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opsagent_tpu.models import llama as jllama
from opsagent_tpu.models.config import TINY_TEST as JAX_TINY
from opsagent_tpu.models.config import RopeScalingConfig as JaxRope
from opsagent_tpu.models.quant import quantize_params
from opsagent_tpu.ops.rope import _scaled_freqs as _jax_scaled_freqs
from opsagent_tpu.ops.rope import rope_table as jax_rope_table
from opsagent_tpu_torch.models.config import TINY_TEST, QWEN25_7B, RopeScalingConfig
from opsagent_tpu_torch.models.convert import params_from_jax
from opsagent_tpu_torch.models.llama import Llama
from opsagent_tpu_torch.ops.rope import _scaled_freqs, rope_table

PAGE, PAGES, MAXP = 4, 32, 8
LLAMA3 = dict(rope_type="llama3", factor=8.0, original_max_position=64,
              low_freq_factor=1.0, high_freq_factor=4.0)
YARN = dict(rope_type="yarn", factor=4.0, original_max_position=64,
            beta_fast=32.0, beta_slow=1.0, mscale=0.707, mscale_all_dim=0.707)
VARIANTS = {
    "attn_bias": dict(attn_bias=True, rms_norm_eps=1e-6),
    "qk_norm": dict(qk_norm=True, head_dim=32, rms_norm_eps=1e-6),
    "tied": dict(tie_embeddings=True),
    "llama3": dict(rope_scaling=LLAMA3),
    "yarn": dict(rope_scaling=YARN),
}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _configs(variant):
    """(JAX config, port config) of one variant."""
    kw = dict(VARIANTS[variant])
    rs = kw.pop("rope_scaling", None)
    jcfg = replace(JAX_TINY, **kw, rope_scaling=rs and JaxRope(**rs))
    tcfg = replace(TINY_TEST, **kw, rope_scaling=rs and RopeScalingConfig(**rs))
    return jcfg, tcfg


def _params(jcfg, quantize=""):
    """JAX init_params with the biases and q/k norms redrawn."""
    params = jllama.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    rng = np.random.default_rng(5)
    layers = params["layers"]
    for name in ("bq", "bk", "bv"):
        if name in layers:
            layers[name] = jnp.asarray(
                rng.normal(0.0, 0.5, layers[name].shape).astype(np.float32))
    for name in ("qn", "kn"):
        if name in layers:
            layers[name] = jnp.asarray(
                rng.normal(1.0, 0.3, layers[name].shape).astype(np.float32))
    return quantize_params(params, quantize) if quantize else params


def _port(tcfg, params, quantize=""):
    model = Llama(tcfg, torch.float32, "cpu", seed=None, quantize=quantize)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg))
    return model


@pytest.mark.parametrize("scaling", [LLAMA3, YARN], ids=["llama3", "yarn"])
@pytest.mark.parametrize("head_dim,theta", [(16, 10000.0), (128, 1000000.0)])
def test_scaled_rope_table_matches_jax(scaling, head_dim, theta):
    """Frequencies to one f32 ulp (XLA's and torch's pow round apart there
    at theta 1e6), tables to 1e-6 at positions where an ulp of frequency
    stays below that."""
    jfreq, jatt = _jax_scaled_freqs(head_dim, theta, JaxRope(**scaling))
    tfreq, tatt = _scaled_freqs(head_dim, theta, RopeScalingConfig(**scaling), torch.device("cpu"))
    np.testing.assert_allclose(tfreq.numpy(), np.asarray(jfreq), rtol=2 ** -23, atol=0)
    assert tatt == jatt
    pos = np.array([[0, 1, 5, 63, 64, 100]], np.int32)
    jc, js = jax_rope_table(jnp.asarray(pos), head_dim, theta, scaling=JaxRope(**scaling))
    tc, ts = rope_table(_t(pos), head_dim, theta, RopeScalingConfig(**scaling))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=1e-6)


def _drive(params, jcfg, model, jkw, tcache, jcache, tol, check_cache=True):
    """Two mixed steps (prefill chunks beside an inactive row, then a decode
    row beside a continuing chunk) and a decode step with an inactive
    lane, through both packages; logits of active rows and the caches
    agree."""
    rng = np.random.default_rng(1)
    B = 3
    table = np.full((B, MAXP), -1, np.int32)
    table[0, :4] = [7, 2, 9, 11]
    table[2, :4] = [4, 0, 13, 5]
    tokens = rng.integers(0, 263, (B, 16)).astype(np.int32)
    for start, q_lens in (([0, 0, 0], [10, 0, 5]), ([10, 0, 5], [1, 0, 6])):
        start, q_lens = np.array(start, np.int32), np.array(q_lens, np.int32)
        want, jcache = jllama.mixed_step(
            params, jcfg, tokens, start, q_lens, jcache, table, **jkw
        )
        got = model.mixed_step(_t(tokens).long(), _t(start), _t(q_lens), tcache,
                               _t(table), backend="grid")
        ok = q_lens > 0
        np.testing.assert_allclose(got.numpy()[ok], np.asarray(want)[ok], rtol=tol, atol=tol)
    toks = np.array([17, 3, 99], np.int32)
    lengths = np.array([11, 0, 11], np.int32)
    active = np.array([True, False, True])
    want, jcache = jllama.decode_step(params, jcfg, toks, lengths, jcache, table, active, **jkw)
    got = model.decode_step(_t(toks).long(), _t(lengths), tcache, _t(table), _t(active),
                            backend="grid")
    np.testing.assert_allclose(got.numpy()[active], np.asarray(want)[active], rtol=tol, atol=tol)
    if check_cache:
        for side, jside in ((tcache.k, jcache["k"]), (tcache.v, jcache["v"])):
            np.testing.assert_allclose(side.numpy(), np.asarray(jside), rtol=tol, atol=tol)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_steps_match_jax(variant, monkeypatch):
    monkeypatch.setenv("OPSAGENT_PALLAS_INTERPRET", "1")
    jcfg, tcfg = _configs(variant)
    params = _params(jcfg)
    model = _port(tcfg, params)
    assert hasattr(model, "lm_head") != tcfg.tie_embeddings
    tokens = np.random.default_rng(0).integers(0, 263, (2, 10)).astype(np.int32)
    want = np.asarray(jllama.forward_full(params, jcfg, tokens, dtype=jnp.float32))
    got = model.forward_full(_t(tokens).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    jcache = jllama.make_cache(jcfg, PAGES, PAGE, dtype=jnp.float32)
    _drive(params, jcfg, model, dict(dtype=jnp.float32, attn_impl="pallas"),
           model.make_cache(PAGES, PAGE), jcache, 1e-4)


@pytest.mark.parametrize("variant", ["attn_bias", "qk_norm", "tied"])
def test_int8_steps_match_jax(variant, monkeypatch):
    """int8 weights and int8 KV; the tied head stays full precision."""
    monkeypatch.setenv("OPSAGENT_PALLAS_INTERPRET", "1")
    jcfg, tcfg = _configs(variant)
    params = _params(jcfg, "int8")
    model = _port(tcfg, params, "int8")
    jcache = jllama.make_cache(jcfg, PAGES, PAGE, dtype=jnp.float32, kv_quantize="int8")
    kw = dict(dtype=jnp.float32, attn_impl="pallas", weight_stream="pallas-dma")
    _drive(params, jcfg, model, kw, model.make_cache(PAGES, PAGE, kv_quantize="int8"),
           jcache, 1e-3, check_cache=False)


def test_random_init_biases_zero_and_qk_norms_one():
    cfg = replace(TINY_TEST, attn_bias=True, qk_norm=True, tie_embeddings=True)
    model = Llama(cfg, torch.float32, "cpu", seed=3)
    layer = model.layers[1]
    assert all((getattr(layer, n) == 0).all() for n in ("bq", "bk", "bv"))
    assert all((getattr(layer, n) == 1).all() for n in ("qn", "kn"))
    assert not hasattr(model, "lm_head")
    assert abs(model.embed.std().item() - cfg.hidden_size ** -0.5) < 0.02


def test_qwen25_7b_preset_matches_jax():
    from opsagent_tpu.models.config import QWEN25_7B as JAX_QWEN

    assert vars(QWEN25_7B) == vars(JAX_QWEN)
    assert QWEN25_7B.num_heads // QWEN25_7B.num_kv_heads == 7
