"""The port's dense Llama against the JAX package's, on the CPU.

``tiny-test`` in f32 with weights from ``opsagent_tpu``'s ``init_params``,
carried across with ``params_from_jax``. Logits of ``forward_full``,
``mixed_step`` and ``decode_step`` match at 1e-4 (f32 sums in another order
through a two-layer stack), and so do the KV caches they write.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opsagent_tpu.models import llama as jllama
from opsagent_tpu.models.config import TINY_TEST as JAX_TINY
from opsagent_tpu.ops.rope import rope_table as jax_rope_table
from opsagent_tpu_torch.models.config import TINY_TEST
from opsagent_tpu_torch.models.convert import params_from_jax
from opsagent_tpu_torch.models.llama import Llama
from opsagent_tpu_torch.ops.rope import rope_table

TOL = 1e-4
PAGE, PAGES, MAXP = 4, 32, 8


@pytest.fixture(scope="module")
def pair():
    params = jllama.init_params(JAX_TINY, jax.random.PRNGKey(0), dtype=jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = Llama(TINY_TEST, torch.float32, "cpu", seed=None)
    model.load_state_dict(params_from_jax(tree, TINY_TEST))
    return params, model


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("head_dim,theta", [(16, 10000.0), (128, 500000.0)])
def test_rope_table_matches_jax(head_dim, theta):
    pos = np.array([[0, 1, 5, 1000, 8191]], np.int32)
    jc, js = jax_rope_table(jnp.asarray(pos), head_dim, theta)
    tc, ts = rope_table(_t(pos), head_dim, theta)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)


def test_forward_full_matches_jax(pair):
    params, model = pair
    tokens = np.random.default_rng(0).integers(0, 263, (2, 10)).astype(np.int32)
    want = np.asarray(jllama.forward_full(params, JAX_TINY, tokens, dtype=jnp.float32))
    got = model.forward_full(_t(tokens).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_init_random_is_fan_in_scaled():
    model = Llama(TINY_TEST, torch.float32, "cpu", seed=3)
    d = TINY_TEST.hidden_size
    assert torch.equal(model.final_norm, torch.ones(d))
    assert abs(model.layers[0].wq.std().item() - d ** -0.5) < 0.02
    assert abs(model.layers[0].wd.std().item() - TINY_TEST.intermediate_size ** -0.5) < 0.02


def test_mixed_and_decode_steps_match_jax(pair):
    """Two mixed steps (prefill chunks, an inactive row, then a decode row
    beside a continuing chunk) and a decode step with an inactive lane:
    logits of active rows and the whole KV cache agree."""
    params, model = pair
    rng = np.random.default_rng(1)
    B = 3
    table = np.full((B, MAXP), -1, np.int32)
    table[0, :4] = [7, 2, 9, 11]
    table[2, :4] = [4, 0, 13, 5]
    jcache = jllama.make_cache(JAX_TINY, PAGES, PAGE, dtype=jnp.float32)
    tcache = model.make_cache(PAGES, PAGE)

    def mixed(tokens, start, q_lens):
        nonlocal jcache
        want, jcache = jllama.mixed_step(
            params, JAX_TINY, tokens, start, q_lens, jcache, table,
            dtype=jnp.float32,
        )
        got = model.mixed_step(
            _t(tokens).long(), _t(start), _t(q_lens), tcache, _t(table)
        )
        ok = q_lens > 0
        np.testing.assert_allclose(
            got.numpy()[ok], np.asarray(want)[ok], rtol=TOL, atol=TOL
        )

    S = 16
    tokens = rng.integers(0, 263, (B, S)).astype(np.int32)
    mixed(tokens, np.array([0, 0, 0], np.int32), np.array([10, 0, 5], np.int32))
    mixed(tokens, np.array([10, 0, 5], np.int32), np.array([1, 0, 6], np.int32))
    for side, jside in ((tcache.k, jcache["k"]), (tcache.v, jcache["v"])):
        np.testing.assert_allclose(side.numpy(), np.asarray(jside), rtol=TOL, atol=TOL)

    toks = np.array([17, 3, 99], np.int32)
    lengths = np.array([11, 0, 11], np.int32)
    active = np.array([True, False, True])
    want, jcache = jllama.decode_step(
        params, JAX_TINY, toks, lengths, jcache, table, active, dtype=jnp.float32
    )
    got = model.decode_step(
        _t(toks).long(), _t(lengths), tcache, _t(table), _t(active)
    )
    np.testing.assert_allclose(
        got.numpy()[active], np.asarray(want)[active], rtol=TOL, atol=TOL
    )
    for side, jside in ((tcache.k, jcache["k"]), (tcache.v, jcache["v"])):
        np.testing.assert_allclose(side.numpy(), np.asarray(jside), rtol=TOL, atol=TOL)


def test_unported_configs_raise():
    """MoE and MLA configurations, refused before they were ported, now
    build and give JAX's logits (tiny-moe, tiny-mla; tests/test_torch_moe.py
    and tests/test_torch_mla.py hold every path); what JAX refuses still
    raises: MLA whose head dim is not its qk head dim, or with GQA."""
    from dataclasses import replace

    from opsagent_tpu.models.config import get_config_preset as jax_preset
    from opsagent_tpu_torch.models.config import get_config_preset

    tokens = np.random.default_rng(0).integers(0, 500, (2, 7)).astype(np.int32)
    for name in ("tiny-moe", "tiny-mla"):
        jcfg, cfg = jax_preset(name), get_config_preset(name)
        params = jllama.init_params(jcfg, jax.random.PRNGKey(1), dtype=jnp.float32)
        model = Llama(cfg, torch.float32, "cpu", seed=None)
        model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg))
        want = np.asarray(jllama.forward_full(params, jcfg, tokens, dtype=jnp.float32))
        np.testing.assert_allclose(model.forward_full(_t(tokens).long()).numpy(), want,
                                   rtol=TOL, atol=TOL)
    mla = get_config_preset("tiny-mla")
    with pytest.raises(ValueError, match="qk_head_dim"):
        Llama(replace(mla, head_dim=16), torch.float32, "cpu")
    with pytest.raises(ValueError, match="no GQA"):
        Llama(replace(mla, num_kv_heads=2), torch.float32, "cpu")
