"""Training checkpoints and HF export of the port, on the CPU.

``save_train_state`` / ``restore_train_state`` / ``latest_step`` (the
``<dir>/step_<N>/`` layout of the JAX package, written atomically through a
temporary directory): a round trip, a resume bit-equal to the
uninterrupted run, missing directories, a half-written temporary
directory. ``save_checkpoint`` both ways against the JAX package's
loader and writer, for dense, MoE (with a sigmoid router's selection
bias) and MLA weights, in f32 and bf16.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opsagent_tpu.models import config as jconfig
from opsagent_tpu.models import llama as jllama
from opsagent_tpu.models.loader import load_checkpoint as jax_load_checkpoint
from opsagent_tpu.models.loader import save_checkpoint as jax_save_checkpoint
from opsagent_tpu_torch.models import config as tconfig
from opsagent_tpu_torch.models.convert import params_from_jax
from opsagent_tpu_torch.models.llama import Llama
from opsagent_tpu_torch.models.loader import (
    CheckpointError,
    load_checkpoint,
    read_safetensors,
    save_checkpoint,
)
from opsagent_tpu_torch.training import (
    TrainConfig,
    init_train_state,
    latest_step,
    make_train_step,
    restore_train_state,
    save_train_state,
)

TC = TrainConfig(learning_rate=3e-3, remat=False)


def _batch(seed):
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, 512, (2, 12)))
    return tokens, torch.ones(2, 12)


def _state(seed=0):
    return init_train_state(tconfig.TINY_TEST, TC, seed=seed, dtype=torch.float32,
                            device="cpu")


def _run(model, optimizer, steps):
    step = make_train_step(tconfig.TINY_TEST, TC)
    return [float(step(model, optimizer, *_batch(s))["loss"]) for s in steps]


def test_round_trip_and_bit_equal_resume(tmp_path):
    model, optimizer = _state()
    _run(model, optimizer, range(2))
    path = save_train_state(str(tmp_path), 2, model, optimizer)
    assert path == str(tmp_path / "step_2") and os.listdir(path) == ["state.pt"]
    want_losses = _run(model, optimizer, range(2, 4))

    fresh, fresh_opt = _state(seed=9)
    _, _, step = restore_train_state(str(tmp_path), fresh, fresh_opt)
    assert step == 2
    got_losses = _run(fresh, fresh_opt, range(2, 4))
    assert got_losses == want_losses
    for (name, p), q in zip(model.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(p, q), name


def test_latest_step_and_missing_directories(tmp_path):
    assert latest_step(str(tmp_path / "nowhere")) is None
    assert latest_step(str(tmp_path)) is None
    model, optimizer = _state()
    with pytest.raises(FileNotFoundError):
        restore_train_state(str(tmp_path), model, optimizer)
    for step in (3, 10):
        save_train_state(str(tmp_path), step, model, optimizer)
    # A save cut short leaves only its temporary directory, which no step
    # name matches; so does anything else beside the steps.
    os.makedirs(tmp_path / ".step_11.abc")
    (tmp_path / ".step_11.abc" / "state.pt").write_bytes(b"\0" * 10)
    os.makedirs(tmp_path / "step_12x")
    assert latest_step(str(tmp_path)) == 10
    assert restore_train_state(str(tmp_path), model, optimizer)[2] == 10
    assert restore_train_state(str(tmp_path), model, optimizer, step=3)[2] == 3
    # Saving a step again replaces it.
    save_train_state(str(tmp_path), 10, model, optimizer)
    assert sorted(os.listdir(tmp_path)) == [".step_11.abc", "step_10", "step_12x", "step_3"]


def _sigmoid_moe():
    import dataclasses

    moe = dict(num_experts=4, num_experts_per_token=2, num_shared_experts=1,
               expert_intermediate_size=64, scoring_func="sigmoid")
    return (dataclasses.replace(jconfig.TINY_MOE, moe=jconfig.MoEConfig(**moe)),
            dataclasses.replace(tconfig.TINY_MOE, moe=tconfig.MoEConfig(**moe)))


CONFIGS = {
    "dense": lambda: (jconfig.TINY_TEST, tconfig.TINY_TEST),
    "moe": _sigmoid_moe,
    "mla": lambda: (jconfig.TINY_MLA, tconfig.TINY_MLA),
}


def _jax_params(jcfg):
    """JAX's init, with a random selection bias, and MLA's ``wo`` pad rows
    at 0: HF's ``o_proj`` has no pad rows, so both writers cut them and
    both loaders put zeros back (they meet v's zero padding, so they never
    change an output)."""
    params = jllama.init_params(jcfg, jax.random.PRNGKey(3), dtype=jnp.float32)
    if jcfg.mla is not None:
        m, H = jcfg.mla, jcfg.num_heads
        for stack in ("layers", "moe_layers"):
            if stack in params:
                wo = params[stack]["wo"]
                L, d = wo.shape[0], wo.shape[-1]
                real = jnp.arange(m.qk_head_dim) < m.v_head_dim
                params[stack]["wo"] = jnp.where(
                    jnp.tile(real, H)[None, :, None], wo, 0.0).reshape(L, -1, d)
    if "router_bias" in params.get("moe_layers", {}):
        rb = params["moe_layers"]["router_bias"]
        params["moe_layers"]["router_bias"] = 0.05 * jax.random.normal(
            jax.random.PRNGKey(4), rb.shape)
    return jax.tree_util.tree_map(np.asarray, params)


def _assert_state_equal(got, want):
    assert sorted(got) == sorted(want)
    for key, t in want.items():
        assert got[key].dtype == t.dtype, key
        assert torch.equal(got[key], t), key


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_port_export_loads_in_jax(name, tmp_path):
    jcfg, tcfg = CONFIGS[name]()
    model = Llama(tcfg, torch.float32, "cpu", seed=None)
    model.load_state_dict(params_from_jax(_jax_params(jcfg), tcfg))
    path = str(tmp_path / "model.safetensors")
    save_checkpoint(path, model, tcfg)
    want = model.state_dict()
    _assert_state_equal(params_from_jax(jax_load_checkpoint(path, jcfg, jnp.float32), tcfg),
                        want)
    _assert_state_equal(load_checkpoint(path, tcfg, torch.float32, device="cpu"), want)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_jax_export_loads_in_the_port(name, tmp_path):
    jcfg, tcfg = CONFIGS[name]()
    params = _jax_params(jcfg)
    path = str(tmp_path / "model.safetensors")
    jax_save_checkpoint(path, params, jcfg)
    want = params_from_jax(jax_load_checkpoint(path, jcfg, jnp.float32), tcfg)
    _assert_state_equal(load_checkpoint(path, tcfg, torch.float32, device="cpu"), want)


def test_bf16_export_keeps_its_dtype(tmp_path):
    """bf16 tensors are written as BF16 (the router stays F32) and read
    back bit for bit, by the port and by the ``safetensors`` package."""
    from safetensors.torch import load_file

    _, tcfg = _sigmoid_moe()
    model = Llama(tcfg, torch.bfloat16, "cpu", seed=2)
    path = str(tmp_path / "model.safetensors")
    save_checkpoint(path, model, tcfg)
    ours, theirs = read_safetensors(path), load_file(path)
    assert sorted(ours) == sorted(theirs)
    for key, t in theirs.items():
        assert torch.equal(ours[key], t), key
    assert ours["model.layers.1.mlp.gate.weight"].dtype == torch.float32
    assert ours["model.embed_tokens.weight"].dtype == torch.bfloat16
    _assert_state_equal(load_checkpoint(path, tcfg, torch.bfloat16, device="cpu"),
                        model.state_dict())
    with pytest.raises(CheckpointError, match="full-precision"):
        save_checkpoint(path, Llama(tcfg, torch.float32, "cpu", seed=2, quantize="int8"), tcfg)
