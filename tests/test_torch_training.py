"""The port's training step against the JAX package's, on the CPU.

The same weights (JAX's ``init_params`` carried across with
``params_from_jax``) and the same batch, made from a numpy seed, take one
and two steps through ``opsagent_tpu.training.make_train_step`` on a
one-device mesh and through the port's ``make_train_step``: the loss,
``grad_norm``, ``moe_aux`` and every updated parameter agree within 1e-6
at f32, with the global-norm clip engaged and not, at tiny-test (2 layers)
and at tiny-moe with a sigmoid router (its selection bias gets no
gradient and still decays) in the grouped dispatch. Then the masked cross
entropy, remat against no remat, a tiny batch overfitted, and the
refusal of quantized weights.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opsagent_tpu.models import config as jconfig
from opsagent_tpu.models import llama as jllama
from opsagent_tpu.parallel.mesh import make_mesh
from opsagent_tpu.training import trainer as jtrainer
from opsagent_tpu_torch.models import config as tconfig
from opsagent_tpu_torch.models.convert import params_from_jax
from opsagent_tpu_torch.models.llama import Llama
from opsagent_tpu_torch.training import (
    TrainConfig,
    cross_entropy_loss,
    init_train_state,
    make_train_step,
)

TOL = 1e-6
B, S = 2, 16


def _t(a):
    return torch.from_numpy(np.array(a))


def _moe_configs():
    """tiny-moe with a sigmoid router over 8 experts, grouped from 16
    tokens (so the B·S = 32 of a step take the grouped form) with a
    capacity that drops assignments."""
    moe = dict(num_experts=8, num_experts_per_token=2, num_shared_experts=1,
               expert_intermediate_size=64, scoring_func="sigmoid",
               grouped_dispatch_min_tokens=16, capacity_factor=0.75)
    return (dataclasses.replace(jconfig.TINY_MOE, moe=jconfig.MoEConfig(**moe)),
            dataclasses.replace(tconfig.TINY_MOE, moe=tconfig.MoEConfig(**moe)))


CONFIGS = {
    "tiny-test": lambda: (jconfig.TINY_TEST, tconfig.TINY_TEST),
    "tiny-moe": _moe_configs,
}


def _batch(vocab, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (B, S), dtype=np.int32)
    mask = (rng.random((B, S)) < 0.7).astype(np.float32)
    return tokens, mask


def _jax_state(jcfg, tc, seed=0):
    params = jllama.init_params(jcfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    if "router_bias" in params.get("moe_layers", {}):
        rb = params["moe_layers"]["router_bias"]
        params["moe_layers"]["router_bias"] = 0.05 * jax.random.normal(
            jax.random.PRNGKey(seed + 7), rb.shape)
    mesh = make_mesh(tp=1, dp=1, sp=1, devices=jax.devices()[:1])
    host = jax.tree_util.tree_map(np.asarray, params)
    params, opt_state = jtrainer.init_train_state(
        jcfg, tc, mesh, jax.random.PRNGKey(seed), dtype=jnp.float32, params=params)
    return host, params, opt_state, mesh


def _port_state(host, tcfg, tc):
    model = Llama(tcfg, torch.float32, "cpu", seed=None)
    model.load_state_dict(params_from_jax(host, tcfg))
    return init_train_state(tcfg, tc, model=model)


def _assert_params_equal(model, params, tcfg):
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for key, t in want.items():
        np.testing.assert_allclose(got[key].detach().numpy(), t.numpy(), rtol=0, atol=TOL,
                                   err_msg=key)


@pytest.mark.parametrize("clip", [0.05, 1e6], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_two_train_steps_match_jax(name, clip):
    jcfg, tcfg = CONFIGS[name]()
    # JAX's default learning rate (1e-5). AdamW's first steps move each
    # parameter by about ±lr whatever its gradient's size, so an element
    # whose gradient is near 0 carries the f32 rounding of that gradient
    # (~1e-7 between the packages here) into up to lr of its update: at lr
    # 1e-3 one element in a thousand parted by 3e-6, at 1e-4 by 2.6e-6.
    tc = dict(weight_decay=0.1, grad_clip=clip, remat=False)
    jtc, ttc = jtrainer.TrainConfig(**tc), TrainConfig(**tc)
    host, params, opt_state, mesh = _jax_state(jcfg, jtc)
    jstep = jtrainer.make_train_step(jcfg, jtc, mesh, dtype=jnp.float32)
    model, optimizer = _port_state(host, tcfg, ttc)
    step = make_train_step(tcfg, ttc)
    for i in range(2):
        tokens, mask = _batch(jcfg.vocab_size, seed=i)
        params, opt_state, want = jstep(params, opt_state, jnp.asarray(tokens),
                                        jnp.asarray(mask))
        got = step(model, optimizer, _t(tokens), _t(mask))
        for key in ("loss", "grad_norm", "moe_aux"):
            np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=0, atol=TOL,
                                       err_msg=f"step {i} {key}")
        assert (float(want["grad_norm"]) >= clip) == (clip < 1)
        if name == "tiny-moe":
            assert float(got["moe_aux"]) > 0
        _assert_params_equal(model, params, tcfg)


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(1)
    logits = (4 * rng.standard_normal((3, 5, 11))).astype(np.float32)
    targets = rng.integers(0, 11, (3, 5), dtype=np.int32)
    for mask in ((rng.random((3, 5)) < 0.5).astype(np.float32), np.zeros((3, 5), np.float32)):
        want = jtrainer.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(targets),
                                           jnp.asarray(mask))
        got = cross_entropy_loss(_t(logits), _t(targets), _t(mask))
        np.testing.assert_allclose(float(got), float(want), rtol=0, atol=TOL)
    assert float(cross_entropy_loss(_t(logits), _t(targets), torch.zeros(3, 5))) == 0.0


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_remat_equals_no_remat(name):
    """Checkpointed layers recompute the same activations: the same step
    with and without remat gives the same metrics and parameters."""
    _, tcfg = CONFIGS[name]()
    tokens, mask = _batch(tcfg.vocab_size, seed=3)
    out = []
    for remat in (False, True):
        tc = TrainConfig(learning_rate=1e-3, remat=remat)
        model, optimizer = init_train_state(tcfg, tc, seed=5, dtype=torch.float32,
                                            device="cpu")
        metrics = make_train_step(tcfg, tc)(model, optimizer, _t(tokens), _t(mask))
        out.append((metrics, model.state_dict()))
    (m0, p0), (m1, p1) = out
    for key in m0:
        assert torch.equal(m0[key], m1[key]), key
    for key in p0:
        assert torch.equal(p0[key], p1[key]), key


def test_overfits_a_tiny_batch():
    tcfg = tconfig.TINY_TEST
    tc = TrainConfig(learning_rate=3e-3, weight_decay=0.0, remat=False)
    model, optimizer = init_train_state(tcfg, tc, seed=0, dtype=torch.float32, device="cpu")
    step = make_train_step(tcfg, tc)
    tokens, mask = _batch(tcfg.vocab_size, seed=4)
    first = float(step(model, optimizer, _t(tokens), _t(mask))["loss"])
    for _ in range(60):
        last = float(step(model, optimizer, _t(tokens), _t(mask))["loss"])
    assert first > 5.0 and last < 0.5, (first, last)


def test_gradients_only_inside_training():
    """Serving builds parameters without gradients; ``init_train_state``
    turns them on for the float parameters, and refuses quantized ones."""
    model = Llama(tconfig.TINY_TEST, torch.float32, "cpu", seed=0)
    assert not any(p.requires_grad for p in model.parameters())
    model, optimizer = init_train_state(tconfig.TINY_TEST, TrainConfig(), model=model)
    assert all(p.requires_grad for p in model.parameters())
    assert sum(len(g["params"]) for g in optimizer.param_groups) == len(list(model.parameters()))
    with pytest.raises(ValueError, match="full-precision"):
        init_train_state(tconfig.TINY_TEST, TrainConfig(),
                         model=Llama(tconfig.TINY_TEST, torch.float32, "cpu", seed=0,
                                     quantize="int8"))
