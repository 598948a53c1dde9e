"""The port's grouped MoE dispatch against the JAX package's, on the CPU.

JAX's ``_moe_mlp`` switches from the all-experts form to the
capacity-bucketed ``_moe_grouped_dispatch`` once a forward holds
``grouped_dispatch_min_tokens`` tokens (512 by default): each (token,
choice) assignment takes a slot of its expert's queue of C = ceil(T·k/E ·
capacity_factor) slots, assignments past C are dropped. The same weights
(JAX's ``init_params`` through ``params_from_jax``) and hidden states go
through both packages' ``_moe_mlp`` with and without drops, in f32, bf16
and with int8 and int4 experts; then ``forward_full`` at tiny-moe's
default threshold, T = 512, with drops (the port ran the all-experts form
there before, and so computed something else).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opsagent_tpu.models import config as jconfig
from opsagent_tpu.models import llama as jllama
from opsagent_tpu_torch.models import config as tconfig
from test_torch_moe import MLP_TOL, _hidden, _params, _port, _t

# (router variant, capacity_factor): E/k = 4 leaves room for every
# assignment; 0.5 drops a good share of them.
CASES = {
    "no_drops": (dict(), 4.0),
    "drops": (dict(), 0.5),
    "sigmoid_groups_drops": (dict(scoring_func="sigmoid", n_group=4, topk_group=2,
                                  norm_topk_prob=True, routed_scaling_factor=2.5), 0.75),
}


def _configs(capacity_factor, min_tokens=1, **moe):
    base = dict(num_experts=8, num_experts_per_token=2, num_shared_experts=1,
                expert_intermediate_size=64, grouped_dispatch_min_tokens=min_tokens,
                capacity_factor=capacity_factor)
    base.update(moe)
    jcfg = dataclasses.replace(jconfig.TINY_MOE, moe=jconfig.MoEConfig(**base))
    tcfg = dataclasses.replace(tconfig.TINY_MOE, moe=tconfig.MoEConfig(**base))
    return jcfg, tcfg


def _jmoe(jcfg):
    """JAX's ``_moe_mlp`` for one config, jitted: one compile in place of
    the many small ones of eager JAX."""
    return jax.jit(lambda h, lp: jllama._moe_mlp(h, lp, jcfg))


def _drops(jcfg, lp, h) -> int:
    """Assignments past capacity under JAX's own routing of ``h``."""
    m = jcfg.moe
    E, k = m.num_experts, m.num_experts_per_token
    T = h.shape[0] * h.shape[1]
    C = max(1, min(T, int(np.ceil(T * k / E * m.capacity_factor))))
    logits = np.asarray(h, np.float32).reshape(T, -1) @ np.asarray(lp["router"])
    probs = np.asarray(jax.nn.sigmoid(logits) if m.scoring_func == "sigmoid"
                       else jax.nn.softmax(logits, axis=-1))
    sel = probs + np.asarray(lp["router_bias"]) if "router_bias" in lp else probs
    if m.n_group > 1:
        g = sel.reshape(T, m.n_group, E // m.n_group)
        gs = (np.sort(g, -1)[..., -2:].sum(-1) if m.scoring_func == "sigmoid"
              else g.max(-1))
        keep = np.argsort(-gs, -1)[:, : m.topk_group]
        mask = np.zeros_like(gs, bool)
        np.put_along_axis(mask, keep, True, -1)
        sel = np.where(mask[..., None], g, -np.inf).reshape(T, E)
    idx = np.argsort(-sel, -1, kind="stable")[:, :k].reshape(-1)
    return int(sum(max(0, c - C) for c in np.bincount(idx, minlength=E)))


def _moe_pair(case, dtype=jnp.float32, mode=""):
    moe, cf = CASES[case]
    jcfg, tcfg = _configs(cf, **moe)
    params = _params(jcfg, dtype=dtype, mode=mode)
    tdtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    layer = _port(params, tcfg, mode, dtype=tdtype).layers[tcfg.moe_layer_start]
    lp = jax.tree_util.tree_map(lambda a: a[0], params["moe_layers"])
    return jcfg, tcfg, layer, lp


@pytest.mark.parametrize("case", sorted(CASES))
def test_grouped_moe_matches_jax(case):
    jcfg, tcfg, layer, lp = _moe_pair(case)
    h = _hidden(jcfg.hidden_size)
    assert (_drops(jcfg, lp, h) > 0) == (case != "no_drops")
    want, want_aux = _jmoe(jcfg)(jnp.asarray(h), lp)
    got, aux = layer.moe_mlp(_t(h), tcfg, with_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MLP_TOL, atol=MLP_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=MLP_TOL, atol=MLP_TOL)


def test_grouped_without_drops_equals_all_experts():
    """With room for every assignment the grouped form computes what the
    all-experts form does (f32, to rounding)."""
    _, tcfg, layer, _ = _moe_pair("no_drops")
    h = _t(_hidden(tcfg.hidden_size))
    full = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, grouped_dispatch_min_tokens=0))
    np.testing.assert_allclose(layer.moe_mlp(h, tcfg)[0].numpy(),
                               layer.moe_mlp(h, full)[0].numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["no_drops", "drops"])
def test_grouped_moe_matches_jax_in_bf16(case, monkeypatch):
    """bf16 weights and hidden states. JAX's ``silu`` rounds its sigmoid to
    bf16 before the product, torch's rounds once: within 2**-4. With
    JAX's ``silu`` rounded once, as torch's, the k terms summed in choice
    order agree bit for bit."""
    jcfg, tcfg, layer, lp = _moe_pair(case, dtype=jnp.bfloat16)
    h = jnp.asarray(_hidden(jcfg.hidden_size)).astype(jnp.bfloat16)
    got = layer.moe_mlp(_t(np.asarray(h.astype(jnp.float32))).bfloat16(), tcfg)[0]
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    # Eager, op by op: XLA's fusions under jit skip some bf16 roundings.
    want, _ = jllama._moe_mlp(h, lp, jcfg)
    np.testing.assert_allclose(got, np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -4, atol=2 ** -4)
    monkeypatch.setattr(jax.nn, "silu", lambda x: (
        x.astype(jnp.float32) * jax.nn.sigmoid(x.astype(jnp.float32))).astype(x.dtype))
    want, _ = jllama._moe_mlp(h, lp, jcfg)
    np.testing.assert_array_equal(got, np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_grouped_quantized_experts_match_jax(mode):
    """The quantized ``_ein``: each stacked expert leaf dequantized to the
    activation dtype, then one batched product (JAX keeps these on XLA)."""
    jcfg, tcfg, layer, lp = _moe_pair("drops", mode=mode)
    h = _hidden(jcfg.hidden_size, seed=4)
    want, _ = _jmoe(jcfg)(jnp.asarray(h), lp)
    got = layer.moe_mlp(_t(h), tcfg)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MLP_TOL, atol=MLP_TOL)


def test_grouped_dispatch_is_differentiable():
    """Gradients through the grouped form equal JAX's (the training path):
    the input's and an expert stack's, with drops."""
    jcfg, tcfg, layer, lp = _moe_pair("drops")
    h = _hidden(jcfg.hidden_size, seed=5)
    g = np.random.default_rng(6).standard_normal(h.shape).astype(np.float32)

    def jloss(x, eg):
        return jnp.sum(jllama._moe_mlp(x, {**lp, "eg": eg}, jcfg)[0] * g)

    want_x, want_eg = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(h), lp["eg"])
    x = _t(h).requires_grad_(True)
    layer.eg.requires_grad_(True)
    (layer.moe_mlp(x, tcfg)[0] * _t(g)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_x), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(layer.eg.grad.numpy(), np.asarray(want_eg),
                               rtol=1e-5, atol=1e-5)


def test_forward_full_at_the_default_threshold_matches_jax():
    """tiny-moe at its default grouped_dispatch_min_tokens (512), T = 512
    tokens, with a capacity factor low enough that assignments drop: the
    port's ``forward_full`` takes the grouped form there, as JAX's does."""
    base = dataclasses.asdict(jconfig.TINY_MOE.moe)
    base["capacity_factor"] = 0.5
    jcfg = dataclasses.replace(jconfig.TINY_MOE, moe=jconfig.MoEConfig(**base))
    tcfg = dataclasses.replace(tconfig.TINY_MOE, moe=tconfig.MoEConfig(**base))
    assert jcfg.moe.grouped_dispatch_min_tokens == 512
    params = _params(jcfg)
    model = _port(params, tcfg)
    tokens = np.random.default_rng(7).integers(0, jcfg.vocab_size, (1, 512), dtype=np.int32)
    want, want_aux = jax.jit(lambda p, t: jllama.forward_full(
        p, jcfg, t, dtype=jnp.float32, return_aux=True))(params, jnp.asarray(tokens))
    with torch.no_grad():
        got, aux = model.forward_full(_t(tokens).long(), return_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=MLP_TOL, atol=MLP_TOL)
