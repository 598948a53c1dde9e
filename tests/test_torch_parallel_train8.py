"""The port's train step at meshes of eight ranks, every data and model
axis real, on the CPU.

One spawn of eight gloo ranks (``tests/_torch_spmd_kit.py``'s ``train``
job) runs two cases, one step at lr 1e-3 each, with remat. tiny-test at
pp2 × dp2 × sp2 with the ring and two microbatches
(``tests/test_pipeline.py``'s ``test_pp2_sp2_dp2_composes`` mesh; eight
ranks hold no tp as well), held against ``opsagent_tpu.training``'s step
at dp2 × sp2 with the ring: the JAX package's pipeline fails at sp > 1
(``tests/_torch_train_oracle.py`` says why), and pipelining a dense stack
is a re-scheduling of the same step. tiny-moe (the grouped dispatch at a
capacity that drops assignments, the balance loss on) at dp2 × sp2 × tp2,
``tests/test_moe.py``'s ``test_sharded_moe_training_step_grouped_dispatch``
mesh, held against JAX's step at that mesh. The loss, ``moe_aux``,
``grad_norm`` and every rank's updated shards and first moments are held
at the oracle module's tolerances.
"""

import pytest

from _torch_spmd_kit import run_ranks
from _torch_train_oracle import DENSE, MOE, case_inputs, check_case, configs, run_with_oracles

TC = dict(learning_rate=1e-3, remat=True, pp_microbatches=2, weight_decay=0.1,
          ring_attention=True)
CASES = {
    "pp2_dp2_sp2": {"name": "pp2_dp2_sp2", "mesh": {"pp": 2, "dp": 2, "sp": 2},
                    "model": DENSE, "weights": "dense", "batches": ["b0"],
                    "jax_mesh": {"dp": 2, "sp": 2}, "tc": TC},
    "moe_dp2_sp2_tp2": {"name": "moe_dp2_sp2_tp2", "mesh": {"dp": 2, "sp": 2, "tp": 2},
                        "model": MOE, "weights": "moe", "batches": ["b0"],
                        "tc": {**TC, "ring_attention": False}},
}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    inputs = case_inputs({"dense": (DENSE, 0), "moe": (MOE, 0)}, {"b0": (4, 32, 3, 512)})
    workdir = tmp_path_factory.mktemp("train8")
    outs, oracles = run_with_oracles(
        lambda: run_ranks("train", 8, workdir, inputs, {"cases": list(CASES.values())},
                          timeout=300),
        CASES, inputs)
    return outs, oracles


def _check(run, name):
    outs, oracles = run
    case = CASES[name]
    metrics, state, mu = oracles[name]
    check_case(outs, name, case["mesh"], configs(case["model"])[1], metrics, state, mu,
               case["tc"])
    return metrics


def test_train_step_matches_jax_at_eight_ranks(run):
    _check(run, "pp2_dp2_sp2")


def test_moe_train_step_matches_jax_at_eight_ranks(run):
    assert _check(run, "moe_dp2_sp2_tp2")[0]["moe_aux"] > 0
