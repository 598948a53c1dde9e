"""The port's train step at a mesh of two ranks against JAX's at the same
mesh, on the CPU.

One spawn of two gloo ranks (``tests/_torch_spmd_kit.py``'s ``train``
job), launched as torch's multi-node launcher launches two hosts of one
rank each (``RANK``/``WORLD_SIZE`` global, ``LOCAL_RANK`` 0 on both), runs
every case in turn: tiny-test one step at lr 1e-3 at pp = 2 (two
microbatches, remat off and on), dp = 2, tp = 2, and sp = 2 with and
without ring attention; tiny-moe (the grouped dispatch at a capacity that
drops assignments, the balance loss on) at dp = 2 and at sp = 2 with the
ring, where each rank routes its slice of the batch against the whole
batch's capacity and adds its share of the balance loss; then the ring's
q/k/v gradients; then a step whose peer leaves. Each case's loss, ``moe_aux``, ``grad_norm`` and every rank's
updated shards are held against ``opsagent_tpu.training``'s step at the
same mesh (``tests/_torch_train_oracle.py``'s tolerances); the ring's
gradients against ``jax.grad`` through JAX's ``make_ring_attention`` at
sp = 2 (JAX's bound, 2e-4), ragged lengths included. Rank-free: the stage
specs and train specs against JAX's, and JAX's divisibility errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opsagent_tpu.parallel import pipeline as jpipeline
from opsagent_tpu.parallel.mesh import make_mesh as jmake_mesh
from opsagent_tpu.parallel.ring import make_ring_attention as jmake_ring
from opsagent_tpu.training import trainer as jtrainer
from opsagent_tpu_torch.models.llama import Llama
from opsagent_tpu_torch.parallel.mesh import Mesh
from opsagent_tpu_torch.parallel.pipeline import make_pipeline_loss, param_specs_pp
from opsagent_tpu_torch.training.trainer import train_param_specs

from _torch_spmd_kit import run_ranks
from _torch_train_oracle import DENSE, MOE, case_inputs, check_case, configs, run_with_oracles
from test_torch_parallel_specs import _flat_jax, _flat_port

TC = dict(learning_rate=1e-3, remat=False, pp_microbatches=2, weight_decay=0.1)
CASES = {  # name: (model, weights, mesh)
    "pp2": (DENSE, "dense", {"pp": 2}),
    "pp2_remat": (DENSE, "dense", {"pp": 2}),
    "dp2": (DENSE, "dense", {"dp": 2}),
    "tp2": (DENSE, "dense", {"tp": 2}),
    "sp2_ring": (DENSE, "dense", {"sp": 2}),
    "sp2_gather": (DENSE, "dense", {"sp": 2}),
    "moe_dp2": (MOE, "moe", {"dp": 2}),
    "moe_sp2_ring": (MOE, "moe", {"sp": 2}),
}
RING_TOL = 2e-4


def _tc(name):
    return {**TC, "remat": name.endswith("remat"), "ring_attention": name.endswith("ring")}


def _ring_inputs():
    rng = np.random.default_rng(5)
    B, S, H, K, D = 2, 16, 4, 2, 16
    out = {}
    for case in ("full", "ragged"):
        for n, h in (("q", H), ("k", K), ("v", K)):
            out[f"{case}/{n}"] = rng.standard_normal((B, S, h, D)).astype(np.float32)
    out["ragged/lengths"] = np.array([S - 3, S // 2 + 1], np.int32)
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The two ranks' outputs, and the inputs they were given."""
    cases = [{"name": n, "mesh": shape, "model": spec, "weights": w, "tc": _tc(n),
              "batches": ["b0"]} for n, (spec, w, shape) in CASES.items()]
    inputs = case_inputs({"dense": (DENSE, 0), "moe": (MOE, 0)}, {"b0": (4, 16, 1, 512)})
    inputs.update(_ring_inputs())
    job = {"cases": cases, "ring_grads": [{"name": "full", "sp": 2}, {"name": "ragged", "sp": 2}],
           "lost_peer": {"mesh": {"dp": 2}, "model": DENSE, "weights": "dense", "tc": TC,
                         "batches": ["b0"], "timeout_s": 10.0}}
    workdir = tmp_path_factory.mktemp("train2")
    outs, oracles = run_with_oracles(
        lambda: run_ranks("train", 2, workdir, inputs, job, timeout=240, hosts=2),
        {c["name"]: c for c in cases}, inputs)
    return outs, inputs, oracles


@pytest.mark.parametrize("name", list(CASES))
def test_train_step_matches_jax_at_two_ranks(run, name):
    outs, inputs, oracles = run
    spec, _, shape = CASES[name]
    metrics, state, mu = oracles[name]
    if spec is MOE:
        assert metrics[0]["moe_aux"] > 0
    check_case(outs, name, shape, configs(spec)[1], metrics, state, mu, _tc(name))


@pytest.mark.parametrize("case", ["full", "ragged"])
def test_ring_gradients_match_jax_grad(run, case):
    """Every rank holds the whole q/k/v gradient of a loss over the whole
    ring output, equal to ``jax.grad`` through JAX's ring."""
    outs, inputs, _ = run
    mesh = jmake_mesh(tp=1, dp=1, sp=2, devices=jax.devices()[:2])
    ring = jmake_ring(mesh)
    lengths = inputs.get(f"{case}/lengths")
    qkv = [jnp.asarray(inputs[f"{case}/{n}"]) for n in "qkv"]

    def loss(q, k, v):
        return jnp.sum(ring(q, k, v, lengths) ** 2)

    with mesh:
        want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*qkv)
    for out in outs:
        for n, w in zip("qkv", want):
            np.testing.assert_allclose(out[f"{case}/d{n}"], np.asarray(w), rtol=RING_TOL,
                                       atol=RING_TOL, err_msg=f"{case} d{n}")


def test_two_hosts_launch_from_torch_variables(run):
    """Each rank joined from the launcher's variables: the global rank and
    world, ``LOCAL_RANK`` 0 on both "hosts"; their dp = 2 step is the
    ``dp2`` case above."""
    outs, _, _ = run
    for r, out in enumerate(outs):
        assert int(out["launch/world"]) == 2 and int(out["launch/rank"]) == r
        assert int(out["launch/local_rank"]) == 0


def test_lost_peer_raises_within_the_group_timeout(run):
    """Rank 1 leaves before a dp = 2 step: rank 0's step raises from its
    gradient all-reduce, within the group's timeout, and does not hang."""
    outs, _, _ = run
    lead = outs[0]
    assert int(lead["lost/raised"]) == 1, lead.get("lost/error")
    assert float(lead["lost/seconds"]) < 2 * 10.0


@pytest.mark.parametrize("spec", [DENSE, MOE], ids=["dense", "moe"])
def test_stage_and_train_specs_equal_jax(spec):
    jcfg, tcfg = configs(spec)
    assert _flat_port(param_specs_pp(tcfg)) == _flat_jax(jpipeline.param_specs_pp(jcfg))
    for shape in ({"pp": 2}, {"tp": 2, "dp": 2}, {"pp": 2, "ep": 2}):
        jmesh = jmake_mesh(devices=jax.devices()[:int(np.prod(list(shape.values())))],
                           **{a: shape.get(a, 1) for a in ("pp", "dp", "sp", "ep", "tp")})
        assert (_flat_port(train_param_specs(tcfg, Mesh.for_rank(shape, 0)))
                == _flat_jax(jtrainer.train_param_specs(jcfg, jmesh))), shape


def test_stage_holds_its_layers_and_the_replicated_rest():
    """tiny-moe with 1 dense and 2 MoE layers at pp = 2: each stage holds
    the dense prefix, its MoE layer, the embedding, the final norm and the
    head, sliced from the one-rank model's draw."""
    _, tcfg = configs(MOE)
    full = Llama(tcfg, torch.float32, "cpu", seed=4).state_dict()
    for stage in range(2):
        model = Llama(tcfg, torch.float32, "cpu", seed=4, mesh=Mesh.for_rank({"pp": 2}, stage))
        assert model.layer_ids == [0, 1 + stage]
        got = model.state_dict()
        assert {k.split(".")[1] for k in got if k.startswith("layers.")} == {"0", str(1 + stage)}
        for k, v in got.items():
            assert torch.equal(v, full[k]), k


@pytest.mark.parametrize("spec,pp,match", [
    (DENSE, 4, "num_layers=2 not divisible by pp=4"),
    ({"preset": "tiny-moe"}, 2, "moe layers 1 not divisible by pp=2"),
])
def test_pipeline_divisibility_errors_are_jax_s(spec, pp, match):
    jcfg, tcfg = configs(spec)
    jmesh = jmake_mesh(pp=pp, dp=1, sp=1, tp=1, devices=jax.devices()[:pp])
    with pytest.raises(ValueError, match=match):
        jpipeline.make_pipeline_loss(jcfg, jmesh, 2, dtype=jnp.float32)
    mesh = Mesh.for_rank({"pp": pp}, 0)
    for build in (lambda: make_pipeline_loss(tcfg, mesh, 2),
                  lambda: train_param_specs(tcfg, mesh),
                  lambda: Llama(tcfg, torch.float32, "cpu", seed=0, mesh=mesh)):
        with pytest.raises(ValueError, match=match):
            build()
