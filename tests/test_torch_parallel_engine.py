"""The lockstep engine at tp = 2 against the JAX package's engine at tp = 2
and the port's at one rank, on the CPU.

``tiny-test`` f32 with the JAX engine's weights on two gloo ranks: the
leader admits three prompts in mixed ticks beside the decode lanes and
block-decodes them (pipelined blocks, their carry form included); the
follower runs every step it is sent. The greedy tokens equal the JAX
engine's at tp = 2 and the port's at one rank; every op's outputs (the
sampled tokens of every tick and block) are equal on both ranks; the
follower returns from ``follow`` on ``stop``, having run every op the
leader ran, and both ran the steps eagerly.
"""

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
from opsagent_tpu_torch.serving.sampler import SamplingParams

from _torch_spmd_kit import drive, run_ranks

MAX_TOKENS = 10
SHAPE = dict(page_size=4, num_pages=64, max_pages_per_seq=32, max_batch_size=4,
             decode_block=4, seed=0)
PROMPTS = [[257] + list(range(40, 60)), [257, 9, 8, 7, 6, 5, 4, 3, 2],
           [257] + list(range(40, 52)) + [100, 101]]


def rank_outputs(out):
    """A rank's recorded ops: [(name, [arrays])]."""
    names = json.loads(str(out["op_names"]))
    return [(n, [out[k] for k in sorted(
        (k for k in out if k.startswith(f"op{i}_")), key=lambda k: int(k.split("_")[1]))])
        for i, n in enumerate(names)]


def assert_ranks_equal(outs):
    lead = rank_outputs(outs[0])
    assert lead, "the leader recorded no op"
    for out in outs[1:]:
        other = rank_outputs(out)
        assert [n for n, _ in other] == [n for n, _ in lead]
        for (name, a), (_, b) in zip(lead, other):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y, err_msg=name)
        assert int(out["ops_run"]) == len(lead)
        assert out["rc"] == 0


@pytest.fixture(scope="module")
def weights():
    jeng = JaxEngine(JaxEngineConfig(
        model="tiny-test", dtype=jnp.float32, tp=2, pipeline_depth=0, **SHAPE))
    assert dict(jeng.mesh.shape)["tp"] == 2
    tree = jax.tree_util.tree_map(np.asarray, jeng.params)
    return jeng, params_from_jax(tree, TINY_TEST)


def test_tp2_engine_tokens_equal_jax_tp2_and_one_rank(tmp_path, weights):
    jeng, state = weights
    want = drive(jeng, PROMPTS, JaxSamplingParams(max_tokens=MAX_TOKENS))
    model = Llama(TINY_TEST, torch.float32, "cpu", seed=None)
    model.load_state_dict(state)
    one = drive(Engine(EngineConfig(model="tiny-test", dtype=torch.float32, device="cpu",
                                    **SHAPE), model=model),
                PROMPTS, SamplingParams(max_tokens=MAX_TOKENS))
    assert one == want
    inputs = {f"state/{k}": v.numpy() for k, v in state.items()}
    outs = run_ranks("engine", 2, tmp_path, inputs, {
        "model": "tiny-test", "mesh": {"tp": 2}, "max_tokens": MAX_TOKENS,
        "prompts": json.dumps(PROMPTS),
        "engine": {"model": "tiny-test", "tp": 2, **SHAPE},
    })
    assert json.loads(str(outs[0]["tokens"])) == want
    assert_ranks_equal(outs)
    names = {n for n, _ in rank_outputs(outs[0])}
    assert {"mixed", "decode"} <= names
    for out in outs:
        assert int(out["mixed_eager_ticks"]) > 0 and int(out["decode_eager_steps"]) > 0
