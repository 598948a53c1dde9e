"""The port's train step at meshes of four ranks against JAX's at the same
meshes, and a train checkpoint resumed at another mesh, on the CPU.

One spawn of four gloo ranks (``tests/_torch_spmd_kit.py``'s ``train``
job) runs every case in turn, one step at lr 1e-3 each: tiny-test at pp2 ×
tp2, pp2 × dp2, pp2 × sp2 with the ring and dp2 × tp2; tiny-moe (a sigmoid
router over 8 experts, 1 dense and 2 MoE layers, the grouped dispatch from
16 tokens at a capacity that drops assignments) at ep2 × tp2, and at dp2 ×
sp2 with the ring and dp2 × ep2, where each rank routes its slice of the
batch against the whole batch's capacity and adds its share of the
balance loss; and JAX's
``test_pp2_moe_with_ep_trains`` model (tiny-moe, 1 dense and 2 MoE layers,
all experts) at pp2 × ep2 with remat and the balance loss on: the
pipelined balance loss is held against JAX's pipelined step, never against
pp = 1. Each is held against ``opsagent_tpu.training``'s step at the same
mesh (``tests/_torch_train_oracle.py``'s tolerances), pp2 × sp2 against
JAX's unpipelined step at sp = 2 (the JAX package's pipeline fails at
sp > 1; the oracle module says why). Then a checkpoint saved
after a step at tp2 × dp2 is restored at pp2 × tp2 and at one rank: the
step resumed there equals the second step of the uninterrupted run, which
equals JAX's two steps.
"""

import numpy as np
import pytest
import torch

from opsagent_tpu_torch.models.llama import _full_shape, local_state, state_specs
from opsagent_tpu_torch.parallel.mesh import Mesh, shard_slices

from _torch_spmd_kit import run_ranks
from _torch_train_oracle import (
    DENSE,
    LOSS_TOL,
    MOE,
    MOE_PP,
    NORM_RTOL,
    PARAM_TOL,
    case_inputs,
    check_case,
    configs,
    run_with_oracles,
)

TC = dict(learning_rate=1e-3, remat=False, pp_microbatches=2, weight_decay=0.1)
CASES = {  # name: (model, weights, mesh, TrainConfig changes)
    "pp2_tp2": (DENSE, "dense", {"pp": 2, "tp": 2}, {}),
    "pp2_dp2": (DENSE, "dense", {"pp": 2, "dp": 2}, {}),
    "pp2_sp2_ring": (DENSE, "dense", {"pp": 2, "sp": 2}, {"ring_attention": True}),
    "dp2_tp2": (DENSE, "dense", {"dp": 2, "tp": 2}, {}),
    "moe_ep2_tp2": (MOE, "moe", {"ep": 2, "tp": 2}, {}),
    "moe_dp2_sp2_ring": (MOE, "moe", {"dp": 2, "sp": 2}, {"ring_attention": True}),
    "moe_dp2_ep2": (MOE, "moe", {"dp": 2, "ep": 2}, {}),
    "moe_pp2_ep2": (MOE_PP, "moe_pp", {"pp": 2, "ep": 2},
                    {"remat": True, "moe_aux_weight": 0.01}),
}
JAX_MESH = {"pp2_sp2_ring": {"sp": 2}}
CKPT = {"model": DENSE, "weights": "dense", "tc": TC, "batches": ["b0", "b1"],
        "save_mesh": {"tp": 2, "dp": 2}, "restore_mesh": {"pp": 2, "tp": 2}}


def _case(name):
    spec, weights, shape, change = CASES[name]
    return {"name": name, "mesh": shape, "model": spec, "weights": weights,
            "tc": {**TC, **change}, "batches": ["b0"], "jax_mesh": JAX_MESH.get(name, shape)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    inputs = case_inputs({"dense": (DENSE, 0), "moe": (MOE, 0), "moe_pp": (MOE_PP, 0)},
                         {"b0": (4, 16, 1, 512), "b1": (4, 16, 2, 512)})
    job = {"cases": [_case(n) for n in CASES], "checkpoint": CKPT}
    workdir = tmp_path_factory.mktemp("train4")
    oracle_cases = {n: _case(n) for n in CASES}
    oracle_cases["ckpt"] = {**CKPT, "mesh": CKPT["save_mesh"]}
    outs, oracles = run_with_oracles(
        lambda: run_ranks("train", 4, workdir, inputs, job, timeout=300), oracle_cases, inputs)
    return outs, inputs, oracles


@pytest.mark.parametrize("name", list(CASES))
def test_train_step_matches_jax_at_four_ranks(run, name):
    outs, inputs, oracles = run
    case = _case(name)
    metrics, state, mu = oracles[name]
    if CASES[name][0] is not DENSE:
        assert metrics[0]["moe_aux"] > 0
    check_case(outs, name, case["mesh"], configs(case["model"])[1], metrics, state, mu,
               case["tc"])


def _assemble(outs, label, shape, tcfg):
    """The full state dict put together from the ranks' shards."""
    specs = state_specs(tcfg)
    full = {}
    for r, out in enumerate(outs):
        mesh = Mesh.for_rank(shape, r)
        for k, v in out.items():
            if not k.startswith(f"{label}/state/"):
                continue
            name = k.removeprefix(f"{label}/state/")
            want = _full_shape(v.shape, specs[name], mesh)
            full.setdefault(name, np.zeros(want, v.dtype))[shard_slices(want, specs[name], mesh)] = v
    return full


def test_uninterrupted_run_matches_jax(run):
    outs, inputs, oracles = run
    metrics, state, _ = oracles["ckpt"]
    check_case(outs, "ckpt/uninterrupted", CKPT["save_mesh"], configs(DENSE)[1], metrics, state)


@pytest.mark.parametrize("where", ["pp2_tp2", "one_rank"])
def test_checkpoint_resumes_at_another_mesh(run, where):
    """Saved at tp2 × dp2 after one step; restored at pp2 × tp2 (every rank)
    or at one rank (rank 0), the next step equals the uninterrupted one."""
    outs, _, _ = run
    tcfg = configs(DENSE)[1]
    full = {k: torch.from_numpy(v) for k, v in
            _assemble(outs, "ckpt/uninterrupted", CKPT["save_mesh"], tcfg).items()}
    label = "ckpt/resumed" if where == "pp2_tp2" else "ckpt/one_rank"
    ranks = outs if where == "pp2_tp2" else outs[:1]
    for r, out in enumerate(ranks):
        assert int(out["ckpt/at"]) == 1
        for key in ("loss", "moe_aux"):
            np.testing.assert_allclose(out[f"{label}/{key}"], out[f"ckpt/uninterrupted/{key}"][1:],
                                       rtol=0, atol=LOSS_TOL)
        np.testing.assert_allclose(out[f"{label}/grad_norm"],
                                   out["ckpt/uninterrupted/grad_norm"][1:], rtol=NORM_RTOL)
        mesh = Mesh.for_rank(CKPT["restore_mesh"], r) if where == "pp2_tp2" else None
        want = local_state(full, tcfg, mesh)
        got = {k.removeprefix(f"{label}/state/"): v for k, v in out.items()
               if k.startswith(f"{label}/state/")}
        assert sorted(got) == sorted(want)
        for k, t in want.items():
            np.testing.assert_allclose(got[k], t.numpy(), rtol=0, atol=PARAM_TOL, err_msg=k)


def test_restore_copies_each_rank_its_region():
    """Rank-free: shards saved over tp = 4 on the rows restore at a mesh
    that splits the columns over tp = 2, each rank copying only the parts
    of the saved shards that overlap its slice; a gap in the saved shards
    raises instead of leaving garbage."""
    from opsagent_tpu_torch.training.checkpoint import _fill

    full = torch.arange(8 * 6, dtype=torch.float32).view(8, 6)
    saved_mesh = {"tp": 4}
    saved = [(Mesh.for_rank(saved_mesh, r),
              full[shard_slices((8, 6), ("tp", None), Mesh.for_rank(saved_mesh, r))])
             for r in range(4)]
    for r in range(4):
        mesh = Mesh.for_rank({"dp": 2, "tp": 2}, r)
        dst = torch.full((8, 3), float("nan"))
        _fill(dst, "w", (None, "tp"), mesh, saved, ("tp", None))
        assert torch.equal(dst, full[shard_slices((8, 6), (None, "tp"), mesh)])
    one = torch.empty(8, 6)
    _fill(one, "w", (None,), None, saved, ("tp", None))
    assert torch.equal(one, full)
    with pytest.raises(ValueError, match="cover 36 of this rank's 48"):
        _fill(one, "w", (None,), None, saved[:3], ("tp", None))
