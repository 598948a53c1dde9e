"""The lockstep engine's sequence parallelism, failures and refusals, on the
CPU.

- sp = 2: a 40-token prompt through the split lane, its first chunk (a
  32-token bucket, fresh) by ring attention over two gloo ranks, the rest
  by the prefix kernel's plain version: the greedy tokens equal the JAX
  engine's at sp = 2 and the port's at one rank, and both ranks' ops give
  equal outputs.
- A follower whose step raises (the ``spmd.follower_step`` fault point)
  makes the leader raise from its next collective, well within the
  groups' timeout, and never hang.
- A mesh engine over gloo refuses CUDA graphs and runs the host KV
  tier, a snapshot and a session migration; a replica registers its
  engine's mesh.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opsagent_tpu.serving.engine import Engine as JaxEngine
from opsagent_tpu.serving.engine import EngineConfig as JaxEngineConfig
from opsagent_tpu.serving.sampler import SamplingParams as JaxSamplingParams
from opsagent_tpu_torch.models.config import TINY_TEST
from opsagent_tpu_torch.models.convert import params_from_jax
from opsagent_tpu_torch.models.llama import Llama
from opsagent_tpu_torch.serving.engine import Engine, EngineConfig
from opsagent_tpu_torch.serving.fleet.client import replica_mesh
from opsagent_tpu_torch.serving.sampler import SamplingParams

from _torch_spmd_kit import GROUP_TIMEOUT_S, drive, run_ranks
from test_torch_parallel_engine import MAX_TOKENS, PROMPTS, SHAPE, assert_ranks_equal

SP_SHAPE = dict(SHAPE, mixed_batching=False, prefill_buckets=(16, 32))
LONG = [257] + [(7 * i + 3) % 250 for i in range(39)]      # 40 tokens: two chunks


def test_sp2_prefill_tokens_equal_jax_sp2_and_one_rank(tmp_path):
    jeng = JaxEngine(JaxEngineConfig(model="tiny-test", dtype=jnp.float32, tp=1, sp=2,
                                     pipeline_depth=0, **SP_SHAPE))
    assert dict(jeng.mesh.shape)["sp"] == 2
    prompts = [LONG, PROMPTS[1]]
    want = drive(jeng, prompts, JaxSamplingParams(max_tokens=MAX_TOKENS), split_lane=True)
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, jeng.params), TINY_TEST)
    model = Llama(TINY_TEST, torch.float32, "cpu", seed=None)
    model.load_state_dict(state)
    one = drive(Engine(EngineConfig(model="tiny-test", dtype=torch.float32, device="cpu",
                                    **SP_SHAPE), model=model),
                prompts, SamplingParams(max_tokens=MAX_TOKENS), split_lane=True)
    assert one == want
    outs = run_ranks("engine", 2, tmp_path, {f"state/{k}": v.numpy() for k, v in state.items()}, {
        "model": "tiny-test", "mesh": {"sp": 2}, "max_tokens": MAX_TOKENS,
        "prompts": json.dumps(prompts), "split_lane": True,
        "engine": {"model": "tiny-test", "sp": 2, **{k: list(v) if isinstance(v, tuple) else v
                                                    for k, v in SP_SHAPE.items()}},
    })
    assert json.loads(str(outs[0]["tokens"])) == want
    assert_ranks_equal(outs)
    names = json.loads(str(outs[0]["op_names"]))
    assert names.count("prefill") >= 3   # LONG's two chunks, then the short prompt


def test_a_failing_follower_makes_the_leader_raise(tmp_path):
    outs = run_ranks("follower_fails", 2, tmp_path, {}, {
        "mesh": {"tp": 2}, "max_tokens": MAX_TOKENS, "prompts": json.dumps(PROMPTS[:1]),
        "engine": {"model": "tiny-test", "tp": 2, **SHAPE},
    }, env={1: {"OPSAGENT_FAULTS": "spmd.follower_step@1"}}, expect_ok=False,
        timeout=3 * GROUP_TIMEOUT_S)
    leader, follower = outs
    assert follower["rc"] != 0 and "injected fault at spmd.follower_step" in follower["stderr"]
    assert leader["rc"] == 0, leader["stderr"][-2000:]
    assert int(leader["raised"]) == 1
    assert float(leader["seconds"]) < 2 * GROUP_TIMEOUT_S


def test_mesh_refusals_and_the_registered_mesh(tmp_path):
    outs = run_ranks("refusals", 2, tmp_path, {}, {"mesh": {"tp": 2}, "tp": 2})
    for out in outs:
        assert int(out["cuda_graphs"]) == 1
        assert "gloo" in str(out["cuda_graphs_msg"])
        assert "cuda_graphs=False" in str(out["cuda_graphs_msg"])
        assert int(out["offload"]) == 0
    lead = outs[0]
    for what in ("snapshot", "migrate"):
        assert int(lead[what]) == 0, str(lead.get(f"{what}_msg"))
    assert int(lead["snapshot_written"]) == 1
    for key in ("local_mesh", "member_mesh"):
        assert json.loads(str(lead[key])) == {"tp": 2, "sp": 1, "ep": 1}


def test_one_rank_engine_registers_the_single_card_mesh():
    eng = Engine(EngineConfig(model="tiny-test", dtype=torch.float32, device="cpu",
                              num_pages=16, max_pages_per_seq=4, page_size=4,
                              max_batch_size=2))
    assert eng.mesh.size == 1 and replica_mesh(eng) == {"tp": 1, "sp": 1, "ep": 1}
    assert eng._channel is None
    with pytest.raises(RuntimeError, match="follower rank"):
        eng.follow()
    eng.stop_followers()  # nothing to stop
    with pytest.raises(ValueError, match="prefill bucket"):
        Engine(dataclasses.replace(eng.cfg, sp=3))
