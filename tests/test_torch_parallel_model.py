"""The sharded model against the JAX package's on a mesh, and against the
port at one rank, on the CPU.

JAX's ``init_params`` weights (quantized with its ``quantize_params`` for
the int8/int4 cases) go to every gloo rank as numpy arrays
(``params_from_jax``); each rank builds its shard (``Llama(mesh=...)``,
``load_full_state_dict``) and runs a fresh prefill, two mixed steps
(decode rows beside chunks, an inactive row) and a decode step with an
inactive lane over its shard of the paged cache. The JAX side runs the same
steps on a mesh of the same shape (params placed by ``param_specs``).
Logits of the active rows agree on every rank, and the ranks' cache shards
put together equal JAX's cache:

- ``tiny-test`` at tp = 2 in f32: 1e-4 against JAX (f32 sums in another
  order, as ``tests/test_torch_model.py``), 1e-5 against the port at one
  rank (the same sums, the row-parallel ones split over two ranks);
- int8 and int4 weights with int8 KV at tp = 2: 1e-3 (as
  ``tests/test_torch_quant_model.py``; KV codes may differ by 1 at an f32
  rounding boundary in under 0.1 % of the entries).

``tests/test_torch_parallel_moe.py`` runs the MoE and MLA cases.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opsagent_tpu.models import config as jconfig
from opsagent_tpu.models import llama as jllama
from opsagent_tpu.models.quant import quantize_params, quantize_specs
from opsagent_tpu.parallel.mesh import make_mesh as jmake_mesh
from opsagent_tpu.parallel.mesh import shard_params as jshard_params
from opsagent_tpu_torch.models import config as tconfig
from opsagent_tpu_torch.models.convert import params_from_jax
from opsagent_tpu_torch.models.llama import Llama

from _torch_spmd_kit import run_ranks

PAGE, PAGES, MAXP, B = 4, 32, 8, 3
CASES = {  # name: (model, mesh, quantize, kv_quantize, tolerance against JAX)
    "dense_tp2": ("tiny-test", {"tp": 2}, "", "", 1e-4),
    "int8_tp2": ("tiny-test", {"tp": 2}, "int8", "int8", 1e-3),
    "int4_tp2": ("tiny-test", {"tp": 2}, "int4", "int8", 1e-3),
}


def _serving(cfg):
    """The serve path's MoE form: all experts, whatever the token count."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, grouped_dispatch_min_tokens=0))


def _steps(rng, vocab):
    table = np.full((B, MAXP), -1, np.int32)
    table[0, :4] = [7, 2, 9, 11]
    table[1, :2] = [3, 14]
    table[2, :4] = [4, 0, 13, 5]
    S = 16
    return dict(
        table=table,
        prefill_tokens=rng.integers(0, vocab, (B, S)).astype(np.int32),
        prefill_lens=np.array([10, 3, 5], np.int32),
        mixed0_tokens=rng.integers(0, vocab, (B, 8)).astype(np.int32),
        mixed0_start=np.array([10, 3, 5], np.int32),
        mixed0_q_lens=np.array([1, 0, 6], np.int32),
        mixed1_tokens=rng.integers(0, vocab, (B, 8)).astype(np.int32),
        mixed1_start=np.array([11, 3, 11], np.int32),
        mixed1_q_lens=np.array([1, 4, 1], np.int32),
        decode_tokens=rng.integers(0, vocab, (B,)).astype(np.int32),
        decode_lengths=np.array([12, 7, 12], np.int32),
        decode_active=np.array([True, False, True]),
    )


def _jax_run(params, cfg, shape, quantize, kv_quantize, x):
    """The steps on a JAX mesh of ``shape``: each step's logits, the cache."""
    n = int(np.prod(list(shape.values())))
    mesh = jmake_mesh(tp=shape.get("tp", 1), ep=shape.get("ep", 1),
                      devices=jax.devices()[:n])
    specs = jllama.param_specs(cfg)
    if quantize:
        params = quantize_params(params, quantize)
        specs = quantize_specs(specs, quantize)
    with mesh:
        p = jshard_params(params, specs, mesh)
        cache = jshard_params(
            jllama.make_cache(cfg, PAGES, PAGE, dtype=jnp.float32, kv_quantize=kv_quantize),
            jllama.cache_specs(cfg, kv_quantize), mesh)
        out = {}
        out["prefill"], cache = jllama.prefill(
            p, cfg, x["prefill_tokens"], x["prefill_lens"], cache, x["table"],
            dtype=jnp.float32)
        for i in range(2):
            out[f"mixed{i}"], cache = jllama.mixed_step(
                p, cfg, x[f"mixed{i}_tokens"], x[f"mixed{i}_start"], x[f"mixed{i}_q_lens"],
                cache, x["table"], dtype=jnp.float32)
        out["decode"], cache = jllama.decode_step(
            p, cfg, x["decode_tokens"], x["decode_lengths"], cache, x["table"],
            x["decode_active"], dtype=jnp.float32)
    return {k: np.asarray(v) for k, v in out.items()}, cache, params


def _port_run(state, cfg, quantize, kv_quantize, x):
    """The same steps through the port at one rank."""
    model = Llama(cfg, torch.float32, "cpu", seed=None, quantize=quantize)
    model.load_state_dict(state)
    cache = model.make_cache(PAGES, PAGE, kv_quantize)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in x.items()}
    out = {}
    with torch.inference_mode():
        out["prefill"] = model.prefill(t["prefill_tokens"].long(), t["prefill_lens"], cache,
                                       t["table"]).numpy()
        for i in range(2):
            out[f"mixed{i}"] = model.mixed_step(
                t[f"mixed{i}_tokens"].long(), t[f"mixed{i}_start"], t[f"mixed{i}_q_lens"],
                cache, t["table"]).numpy()
        out["decode"] = model.decode_step(t["decode_tokens"].long(), t["decode_lengths"],
                                          cache, t["table"], t["decode_active"]).numpy()
    return out


def _rows(step, x):
    if step == "prefill":
        return x["prefill_lens"] > 0
    if step == "decode":
        return x["decode_active"]
    return x[f"{step}_q_lens"] > 0


def _jax_cache_leaves(cache):
    out = {}
    for side in ("k", "v"):
        leaf = cache[side]
        if hasattr(leaf, "q"):
            out[f"{side}.q"], out[f"{side}.scale"] = np.asarray(leaf.q), np.asarray(leaf.scale)
        else:
            out[side] = np.asarray(leaf)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_steps_match_jax_and_one_rank(tmp_path, case):
    check_case(tmp_path, *CASES[case])


def check_case(tmp_path, name, shape, quantize, kv_quantize, tol):
    jcfg = _serving(jconfig.get_config_preset(name))
    tcfg = _serving(tconfig.get_config_preset(name))
    params = jllama.init_params(jcfg, jax.random.PRNGKey(3), dtype=jnp.float32)
    x = _steps(np.random.default_rng(5), tcfg.vocab_size)
    want, jcache, jparams = _jax_run(params, jcfg, shape, quantize, kv_quantize, x)
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg)
    inputs = {**x, **{f"state/{k}": v.numpy() for k, v in state.items()}}
    n = int(np.prod(list(shape.values())))
    outs = run_ranks("model", n, tmp_path, inputs, {
        "model": name, "quantize": quantize, "kv_quantize": kv_quantize, "mesh": shape,
        "pages": PAGES, "page_size": PAGE, "all_experts": True,
    })
    one = _port_run(state, tcfg, quantize, kv_quantize, x)
    for step in ("prefill", "mixed0", "mixed1", "decode"):
        ok = _rows(step, x)
        for out in outs:
            np.testing.assert_allclose(out[step][ok], want[step][ok], rtol=tol, atol=tol)
            one_tol = tol if quantize else 1e-5
            np.testing.assert_allclose(out[step][ok], one[step][ok], rtol=one_tol,
                                       atol=one_tol)
    # The tp ranks' cache shards (ep index 0) side by side are JAX's cache.
    tp = shape.get("tp", 1)
    jleaves = _jax_cache_leaves(jcache)
    latent = tcfg.mla is not None and tcfg.mla.latent_cache
    for leaf, want_leaf in jleaves.items():
        parts = [outs[r][f"cache/{leaf}"] for r in range(tp)]
        got = parts[0] if latent else np.concatenate(parts, axis=3)
        if leaf.endswith(".q"):
            diff = np.abs(got.astype(np.int32) - want_leaf.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, leaf
        elif leaf.endswith(".scale"):
            np.testing.assert_allclose(got, want_leaf, rtol=1e-5, atol=0)
        else:
            np.testing.assert_allclose(got, want_leaf, rtol=tol, atol=tol)
