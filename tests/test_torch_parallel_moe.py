"""The sharded MoE and MLA models against the JAX package's on a mesh, and
against the port at one rank, on the CPU: ``tiny-moe`` at ep = 2 × tp = 2
(four gloo ranks: each holds E/ep experts of fe/tp columns, the routed sum
all-reduced over ep and tp) and ``tiny-mla`` at tp = 2 (heads over tp, the
latent path's down-projections whole on every rank), in f32 at 1e-4 against
JAX, 1e-5 against one rank. The steps and checks are
``tests/test_torch_parallel_model.py``'s."""

import pytest

from test_torch_parallel_model import check_case

CASES = {
    "moe_ep2_tp2": ("tiny-moe", {"ep": 2, "tp": 2}, "", "", 1e-4),
    "mla_tp2": ("tiny-mla", {"tp": 2}, "", "", 1e-4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_moe_and_mla_match_jax_and_one_rank(tmp_path, case):
    check_case(tmp_path, *CASES[case])
