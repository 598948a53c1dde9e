"""JAX's train step as the oracle of the port's at a mesh, for the
``test_torch_parallel_train*`` tests.

A case is a model (a preset with overrides), a mesh shape, a
``TrainConfig``'s fields and its batches. ``case_inputs`` makes its
weights (numpy draws in the tree of JAX's ``init_params``, carried
across by ``params_from_jax``) and batches from numpy seeds, as the ranks of
``tests/_torch_spmd_kit.py``'s ``train`` job read them; ``jax_steps`` runs
JAX's ``make_train_step`` at the same mesh on the 8-device CPU mesh of
``tests/conftest.py``; ``check_case`` holds each rank's metrics and shards
against it at the tolerances of JAX's own tests: loss and ``moe_aux``
within 1e-5 absolute (``tests/test_pipeline.py``), ``grad_norm`` within
1e-4 relative (``tests/test_ring_attention.py``) and every updated
parameter within 1e-4 absolute.

One exception, from AdamW and not from either program: where a gradient
cancels to summation noise, AdamW's first step turns that noise into up
to lr of the update. So in a one-step case an element in the noise band
(``opsagent_tpu_torch.training.parity``: its gradient nonzero and below
2e-5 of its tensor's largest, both read from JAX's first moment ``mu``) is
held by its first moment, the rank's ``exp_avg`` against JAX's ``mu``, and
its parameter only within lr. The port's one-rank step parted from JAX's
by 1.4e-4 at an element whose gradient was 5.9e-9 (tiny-test, batch 4 ×
32, lr 1e-3), and JAX's own one-device and dp2 × sp2 steps by 1.9e-5
there. Every element's first moment is held to JAX's, in the band or not.
``check_case`` returns how many band elements there were.

A case may name ``jax_mesh``, the mesh JAX's step runs at when it cannot
run at the port's: the JAX package's pipeline fails at sp > 1 (it calls
``_local_ring_attention`` without its ``sp`` argument) and in the grouped
MoE dispatch at ep > 1 (``_ep_constrain`` inside the pipeline's
``shard_map``). A dense pipeline at pp × sp is then held against JAX's
unpipelined step at the same dp and sp, which JAX's own
``test_pp2_sp2_ring_matches_pp1_oracle`` holds equal to it.
"""

from __future__ import annotations

import dataclasses

import numpy as np

LOSS_TOL, NORM_RTOL, PARAM_TOL = 1e-5, 1e-4, 1e-4

# tiny-moe as the port's training tests run it: a sigmoid router over 8
# experts (its selection bias gets no gradient and still decays), grouped
# from 16 tokens with a capacity that drops assignments; 1 dense and 2
# MoE layers, so that the MoE stack divides over pp = 2.
MOE = {"preset": "tiny-moe", "change": {
    "num_layers": 3,
    "moe": dict(num_experts=8, num_experts_per_token=2, num_shared_experts=1,
                expert_intermediate_size=64, scoring_func="sigmoid",
                grouped_dispatch_min_tokens=16, capacity_factor=0.75)}}
DENSE = {"preset": "tiny-test"}
# JAX's ``test_pp2_moe_with_ep_trains`` model: tiny-moe's softmax router in
# the all-experts form, 1 dense and 2 MoE layers.
MOE_PP = {"preset": "tiny-moe", "change": {"num_layers": 3}}


def configs(spec: dict):
    """(JAX's config, the port's) of a model spec."""
    from opsagent_tpu.models import config as jconfig
    from opsagent_tpu_torch.models import config as tconfig

    out = []
    for mod in (jconfig, tconfig):
        change = dict(spec.get("change", {}))
        if "moe" in change:
            change["moe"] = mod.MoEConfig(**change["moe"])
        out.append(dataclasses.replace(mod.get_config_preset(spec["preset"]), **change))
    return tuple(out)


def host_params(jcfg, seed: int = 0) -> dict:
    """f32 weights in the tree of JAX's ``init_params``, drawn with numpy
    (no compile): norms at 1, biases at 0, a sigmoid router's selection
    bias small and away from 0, the rest normal at std fan_in^-1/2."""
    import jax
    import jax.numpy as jnp

    from opsagent_tpu.models import llama as jllama

    shapes = jax.eval_shape(
        lambda: jllama.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(path[-1].key)
        if name.endswith("norm") or name in ("qn", "kn"):
            return np.ones(leaf.shape, np.float32)
        if name in ("bq", "bk", "bv"):
            return np.zeros(leaf.shape, np.float32)
        scale = 0.05 if name == "router_bias" else (
            leaf.shape[-1] if name == "embed" else leaf.shape[-2]) ** -0.5
        return (rng.standard_normal(leaf.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def batch(vocab: int, B: int, S: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Random tokens and a loss mask with about 30 % of the targets off."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (B, S), dtype=np.int32)
    mask = (rng.random((B, S)) < 0.7).astype(np.float32)
    return tokens, mask


def case_inputs(weights: dict[str, tuple[dict, int]], batches: dict[str, tuple]) -> dict:
    """The ranks' inputs: ``weights`` name -> (model spec, seed) and
    ``batches`` name -> (B, S, seed, vocab)."""
    from opsagent_tpu_torch.models.convert import params_from_jax

    out = {}
    for name, (spec, seed) in weights.items():
        jcfg, tcfg = configs(spec)
        for k, t in params_from_jax(host_params(jcfg, seed), tcfg).items():
            out[f"w/{name}/{k}"] = t.numpy()
    for name, (B, S, seed, vocab) in batches.items():
        out[f"batch/{name}/tokens"], out[f"batch/{name}/mask"] = batch(vocab, B, S, seed)
    return out


def jax_steps(case: dict, inputs: dict, weight_seed: int = 0) -> tuple[list[dict], dict, dict]:
    """JAX's steps of ``case`` at its mesh: (each step's metrics, the
    updated parameters, AdamW's first moment ``mu``), the last two as the
    port's full state dict, numpy."""
    import jax
    import jax.numpy as jnp
    import optax

    from opsagent_tpu.parallel.mesh import make_mesh
    from opsagent_tpu.training import trainer as jtrainer
    from opsagent_tpu_torch.models.convert import params_from_jax

    jcfg, tcfg = configs(case["model"])
    at = case.get("jax_mesh", case["mesh"])
    shape = {a: at.get(a, 1) for a in ("pp", "dp", "sp", "ep", "tp")}
    n = int(np.prod(list(shape.values())))
    mesh = make_mesh(devices=jax.devices()[:n], **shape)
    tc = jtrainer.TrainConfig(**case["tc"])
    params, opt = jtrainer.init_train_state(
        jcfg, tc, mesh, jax.random.PRNGKey(0), dtype=jnp.float32,
        params=jax.tree_util.tree_map(jnp.asarray, host_params(jcfg, weight_seed)))
    step = jtrainer.make_train_step(jcfg, tc, mesh, dtype=jnp.float32)
    metrics = []
    for b in case["batches"]:
        params, opt, m = step(params, opt, jnp.asarray(inputs[f"batch/{b}/tokens"]),
                              jnp.asarray(inputs[f"batch/{b}/mask"]))
        metrics.append({k: float(v) for k, v in m.items()})
    adam = [s for s in jax.tree_util.tree_leaves(
        opt, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(adam) == 1, adam

    def port(tree):
        host = jax.tree_util.tree_map(lambda a: np.asarray(jax.device_get(a)), tree)
        return {k: t.numpy() for k, t in params_from_jax(host, tcfg).items()}

    return metrics, port(params), port(adam[0].mu)


def run_with_oracles(spawn, cases: dict[str, dict], inputs: dict) -> tuple[list[dict], dict]:
    """``spawn()`` (the ranks, in a thread: they are other processes) while
    this process computes ``jax_steps`` of the cases, several at once on a
    pool of four threads that the spawn shares (most of their time is XLA's
    compile): (the ranks' outputs, {case name: JAX's (metrics, state,
    mu)})."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(4) as pool:
        ranks = pool.submit(spawn)
        oracles = {name: pool.submit(jax_steps, case, inputs) for name, case in cases.items()}
        return ranks.result(), {name: f.result() for name, f in oracles.items()}


def check_case(outs: list[dict], label: str, shape: dict, tcfg, metrics: list[dict],
               state: dict, mu: dict | None = None, tc: dict | None = None) -> int:
    """Every rank's metrics equal JAX's, and its shards the slices of JAX's
    updated parameters at its place in ``shape``. With ``mu`` (JAX's first
    moment after a one-step case) and the case's ``tc``, every rank's
    first moment is held to the slices of ``mu`` as well, and the elements
    in the noise band (the module docstring) by it; returns how many there
    were."""
    from opsagent_tpu_torch.models.llama import local_state
    from opsagent_tpu_torch.parallel.mesh import Mesh
    from opsagent_tpu_torch.training.parity import moment_bound, noise_band, param_bound

    import torch

    full = {k: torch.from_numpy(v) for k, v in state.items()}
    bounds = {k: torch.full(v.shape, PARAM_TOL) for k, v in full.items()}
    moments, moment_bounds, loose = {}, {}, 0
    if mu is not None:
        assert len(metrics) == 1
        for k, v in mu.items():
            m = torch.from_numpy(v)
            largest = float(m.abs().max())
            band = noise_band(m, largest)
            bounds[k] = param_bound(band, tc["learning_rate"], PARAM_TOL)
            moments[k], moment_bounds[k] = m, moment_bound(m, largest, NORM_RTOL)
            loose += int(band.sum())
    for r, out in enumerate(outs):
        for key in ("loss", "moe_aux"):
            np.testing.assert_allclose(out[f"{label}/{key}"], [m[key] for m in metrics],
                                       rtol=0, atol=LOSS_TOL, err_msg=f"{label} rank {r} {key}")
        np.testing.assert_allclose(out[f"{label}/grad_norm"], [m["grad_norm"] for m in metrics],
                                   rtol=NORM_RTOL, atol=0, err_msg=f"{label} rank {r} grad_norm")
        mesh = Mesh.for_rank(shape, r) if shape else None
        got = {k.removeprefix(f"{label}/state/"): v for k, v in out.items()
               if k.startswith(f"{label}/state/")}
        want = local_state(full, tcfg, mesh)
        assert sorted(got) == sorted(want), (label, r)
        held = [("state", got, want, local_state(bounds, tcfg, mesh))]
        if mu is not None:
            held.append(("mu", {k: out[f"{label}/mu/{k}"] for k in want},
                         local_state(moments, tcfg, mesh), local_state(moment_bounds, tcfg, mesh)))
        for what, mine, ref, bound in held:
            for k, t in ref.items():
                err = np.abs(mine[k] - t.numpy())
                allowed = bound[k].numpy()
                worst = np.unravel_index(np.argmax(err - allowed), err.shape)
                assert (err <= allowed).all(), (
                    f"{label} rank {r} {what} {k}{list(worst)}: |{mine[k][worst]} - "
                    f"{t.numpy()[worst]}| > {allowed[worst]}")
    return loose
