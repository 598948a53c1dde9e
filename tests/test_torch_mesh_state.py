"""The serve path's state at a mesh: the host KV tier, session migration and
snapshots of a tp = 2 engine, on two gloo ranks on the CPU, against the
JAX package's engine at tp = 2 (its virtual CPU mesh) and the port's at one
rank, all over the JAX engine's ``tiny-test`` f32 weights.

One spawn of two ranks (``tests/_torch_spmd_kit.py`` ``job_mesh_state``)
serves the whole script; the checks below read its outputs:

- a session served at tp = 2 and parked gives a pool of whole pages (the
  ranks' kv heads side by side, in tp order) of the one-rank engine's and
  the JAX tp = 2 engine's shapes and dtypes. Layer 0's K/V bytes equal the
  one-rank engine's exactly (nothing summed over ranks precedes them, so
  any slip of a head would show); every later layer's agree with both
  within f32 rounding (1e-5): a tp = 2 step sums its row-parallel partials
  over the ranks, in another order than one rank's product, as XLA's tp =
  2 program does in its own. The continuation from the restored pages
  gives the one-rank engine's tokens; the follower's pool stays empty;
- migration both ways: the records the tp = 2 replica ships
  (``migrate_chain``) are the pool's bytes, unpack in the JAX package and
  in a one-rank engine to those bytes, and restore in the one-rank engine
  to its own continuation; the one-rank engine's records and the JAX
  engine's restore at tp = 2 to their own continuations;
- a snapshot written at tp = 2 records its mesh, holds the leaf bytes of
  the one-rank engine's snapshot of the same weights, passes JAX's
  ``verify_snapshot`` and restores in the JAX package at tp = 2, and in the
  port at tp = 2, to the JAX engine's greedy tokens; the JAX engine's own
  tp = 2 snapshot restores in the port at tp = 2 to the same tokens; int4
  weights whose scale groups shard with their rows write the leaves of a
  one-rank snapshot too;
- a one-rank snapshot is refused in the two-rank job with the world sizes
  named, and CUDA graphs over gloo are refused.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opsagent_tpu.serving.engine import Engine as JaxEngine
from opsagent_tpu.serving.engine import EngineConfig as JaxEngineConfig
from opsagent_tpu.serving.fleet import transfer as jtransfer
from opsagent_tpu.serving.sampler import SamplingParams as JaxSamplingParams
from opsagent_tpu.serving.snapshot import restore as jrestore
from opsagent_tpu.serving.snapshot import verify_snapshot as jax_verify
from opsagent_tpu_torch.models.config import TINY_TEST
from opsagent_tpu_torch.models.convert import leaf_bytes, params_from_jax
from opsagent_tpu_torch.models.llama import Llama
from opsagent_tpu_torch.models.quant import _QUANT_KEYS, quantize_weight4
from opsagent_tpu_torch.serving.engine import Engine, EngineConfig
from opsagent_tpu_torch.serving.fleet import transfer as ptransfer
from opsagent_tpu_torch.serving.snapshot import verify_snapshot
from opsagent_tpu_torch.serving.snapshot.manifest import read_manifest

from _torch_spmd_kit import _run, run_ranks

MAX_TOKENS = 8
SHAPE = dict(page_size=4, num_pages=64, max_pages_per_seq=32, max_batch_size=4,
             decode_block=4, seed=0, prefill_buckets=(16, 32))
PROMPTS = [[257] + list(range(40, 60)), [257, 9, 8, 7, 6, 5, 4, 3, 2]]
PARKED = [257] + list(range(20, 41))          # served and parked at tp = 2
FROM_ONE = [257] + list(range(120, 139))      # parked at one rank, moved in
FROM_JAX = [257] + list(range(160, 177))      # parked by JAX, moved in
TURN = [33, 44, 55]


def _park(eng, prompt):
    """Serve ``prompt`` on a port engine, park its history: (tokens,
    history, the pool's entries of it)."""
    first = _run(eng, prompt, MAX_TOKENS)
    hist = prompt + first[:-1]
    eng.park_chain(hist)
    eng.offload_flush()
    return first, hist, eng.offload.pool.match(hist)


def _jax_park(jeng, prompt):
    first = jeng.generate([prompt], JaxSamplingParams(max_tokens=MAX_TOKENS))[0]
    hist = prompt + first[:-1]
    jeng.park_chain(hist)
    jeng.offload_flush()
    return first, hist, jeng.offload.pool.match(hist)


def _aligned(records):
    return list(records[-1]["tokens"])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    where = tmp_path_factory.mktemp("mesh_state")
    jeng = JaxEngine(JaxEngineConfig(model="tiny-test", dtype=jnp.float32, tp=2,
                                     pipeline_depth=0, offload=True, **SHAPE))
    assert dict(jeng.mesh.shape)["tp"] == 2
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, jeng.params), TINY_TEST)
    jax_want = jeng.generate(PROMPTS, JaxSamplingParams(max_tokens=MAX_TOKENS))
    jeng.snapshot(str(where / "jax-snap"))
    jax_first, _, jax_pool = _jax_park(jeng, PARKED)
    _, _, jax_moved = _jax_park(jeng, FROM_JAX)
    jax_records = jtransfer.pack_entries(jax_moved)
    jax_continued = jeng.generate([_aligned(jax_records) + TURN],
                                  JaxSamplingParams(max_tokens=MAX_TOKENS))[0]

    model = Llama(TINY_TEST, torch.float32, "cpu", seed=None)
    model.load_state_dict(state)
    one = Engine(EngineConfig(model="tiny-test", dtype=torch.float32, device="cpu",
                              offload=True, **SHAPE), model=model)
    one_first, one_hist, one_pool = _park(one, PARKED)
    one_pool = [{k: t.clone() for k, t in e.data.items()} for e in one_pool]
    one_records_parked = ptransfer.pack_entries(one.offload.pool.match(one_hist))
    one_continued = _run(one, one_hist + TURN, MAX_TOKENS)
    _, _, moved = _park(one, FROM_ONE)
    one_records = ptransfer.pack_entries(moved)
    one_moved_continued = _run(one, _aligned(one_records) + TURN, MAX_TOKENS)
    one.snapshot(str(where / "one-snap"))
    # int4 in groups of 16 rows: wo's and wd's groups shard with their rows.
    q4 = {}
    for name, t in state.items():
        if name.rsplit(".", 1)[-1] in _QUANT_KEYS:
            w = quantize_weight4(t, group=16)
            q4[f"{name}.q"], q4[f"{name}.scale"] = w.q, w.scale
        else:
            q4[name] = t
    model4 = Llama(TINY_TEST, torch.float32, "cpu", seed=None, quantize="int4")
    model4.load_state_dict(q4)
    Engine(EngineConfig(model="tiny-test", dtype=torch.float32, device="cpu", quantize="int4",
                        offload=True, **SHAPE), model=model4).snapshot(str(where / "one-snap4"))

    inputs = {f"state/{k}": v.numpy() for k, v in state.items()}
    inputs.update({f"q4/{k}": v.numpy() for k, v in q4.items()})
    inputs["one_records"] = np.array(json.dumps(one_records))
    inputs["jax_records"] = np.array(json.dumps(jax_records))
    outs = run_ranks("mesh_state", 2, where / "ranks", inputs, {
        "model": "tiny-test", "mesh": {"tp": 2}, "max_tokens": MAX_TOKENS,
        "prompts": json.dumps(PROMPTS), "parked": PARKED, "turn": TURN,
        "engine": {"model": "tiny-test", "tp": 2, "offload": True,
                   **{k: list(v) if isinstance(v, tuple) else v for k, v in SHAPE.items()}},
        "port_snapshot": str(where / "port-snap"), "jax_snapshot": str(where / "jax-snap"),
        "one_snapshot": str(where / "one-snap"), "int4_snapshot": str(where / "port-snap4"),
    }, timeout=240)
    return dict(outs=outs, where=where, jeng=jeng, one=one, jax_want=jax_want,
                jax_first=jax_first, jax_pool=jax_pool, jax_continued=jax_continued,
                one_first=one_first, one_pool=one_pool, one_continued=one_continued,
                one_records_parked=one_records_parked,
                one_moved_continued=one_moved_continued)


def _lead(run):
    return run["outs"][0]


def test_parked_pool_holds_whole_pages_equal_to_one_rank_and_jax(run):
    lead = _lead(run)
    assert json.loads(str(lead["first"])) == run["one_first"] == run["jax_first"]
    pool = sorted({int(k.split("/")[1]) for k in lead if k.startswith("pool/")})
    assert len(pool) == len(run["one_pool"]) == len(run["jax_pool"]) > 0
    for j in pool:
        ours = {k.split("/")[2]: lead[k] for k in lead if k.startswith(f"pool/{j}/")}
        one = run["one_pool"][j]
        jleaves = jax.tree_util.tree_leaves(run["jax_pool"][j].data)
        assert list(ours) == list(one) and len(jleaves) == len(ours)
        for (name, got), jl in zip(ours.items(), jleaves):
            want, jwant = one[name].numpy(), np.asarray(jl)
            assert got.shape == want.shape == jwant.shape and got.dtype == jwant.dtype
            assert got[0].tobytes() == want[0].tobytes(), name
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=name)
            np.testing.assert_allclose(got, jwant, rtol=1e-5, atol=1e-5, err_msg=name)
    assert int(run["outs"][1]["follower_pool_pages"]) == 0


def test_parked_session_continues_from_restored_pages(run):
    lead = _lead(run)
    assert json.loads(str(lead["snapshot_mesh"]))["tp"] == 2
    assert int(lead["restored_pages"]) == len(run["one_pool"])
    assert json.loads(str(lead["continued"])) == run["one_continued"]


def test_migrated_records_cross_to_one_rank_and_jax(run):
    lead = _lead(run)
    records = json.loads(str(lead["records"]))
    pool = [{k.split("/")[2]: lead[k] for k in lead if k.startswith(f"pool/{j}/")}
            for j in range(len(records))]
    assert int(lead["migrated_out"]) == len(records) == len(run["one_records_parked"])
    assert [r["tokens"] for r in records] == [r["tokens"] for r in run["one_records_parked"]]
    one = run["one"]
    jgot = jtransfer.unpack_entries(records, run["jeng"].cache)
    pgot = ptransfer.unpack_entries(records, one.cache)
    assert len(jgot) == len(pgot) == len(records)
    for page, (_, jtree), (_, ptree) in zip(pool, jgot, pgot):
        jleaves = jax.tree_util.tree_leaves(jtree)
        for (name, want), jl in zip(page.items(), jleaves):
            assert np.asarray(jl).tobytes() == leaf_bytes(ptree[name]) == want.tobytes()
    # The tp = 2 replica's records restore in a one-rank engine.
    hist = PARKED + json.loads(str(lead["first"]))[:-1]
    one.park_chain(hist)   # nothing of it stays local: the imported pages restore
    one.offload.pool.clear()
    for toks, tree in ptransfer.unpack_entries(records, one.cache):
        assert one.offload.pool.put(toks, tree)
    before = one.offload.restored_pages
    assert _run(one, hist + TURN, MAX_TOKENS) == run["one_continued"]
    assert one.offload.restored_pages - before == len(records)


@pytest.mark.parametrize("source", ["one", "jax"])
def test_migrated_in_records_restore_at_tp2(run, source):
    lead = _lead(run)
    assert int(lead[f"{source}_imported"]) > 0
    assert int(lead[f"{source}_restored_pages"]) == int(lead[f"{source}_imported"])
    want = run["one_moved_continued"] if source == "one" else run["jax_continued"]
    assert json.loads(str(lead[f"{source}_continued"])) == want


@pytest.mark.parametrize("weights", ["f32", "int4"])
def test_tp2_snapshot_holds_one_rank_leaves_and_verifies_in_jax(run, weights):
    where = run["where"]
    suffix = "4" if weights == "int4" else ""
    path, one_path = str(where / f"port-snap{suffix}"), str(where / f"one-snap{suffix}")
    if weights == "int4":
        # Groups that shard with their rows are gathered back in rank order.
        assert int(_lead(run)["int4_split_scales"]) > 0
    man, one_man = read_manifest(path), read_manifest(one_path)
    assert man["engine"]["tp"] == 2 and man["torch"]["mesh"]["tp"] == 2
    assert [(r["path"], r["shape"], r["digest"]) for r in man["leaves"]] == [
        (r["path"], r["shape"], r["digest"]) for r in one_man["leaves"]]
    for rec in man["leaves"]:
        with open(os.path.join(path, rec["file"]), "rb") as a, \
                open(os.path.join(one_path, rec["file"]), "rb") as b:
            assert a.read() == b.read(), rec["path"]
    # The kv plan records the global cache leaves, as JAX's does.
    assert man["kv_plan"]["leaves"] == one_man["kv_plan"]["leaves"]
    for verify in (jax_verify, verify_snapshot):
        rep = verify(path)
        assert rep["ok"] and not rep["errors"], rep


def test_tp2_snapshot_restores_in_jax_at_tp2(run):
    path = str(run["where"] / "port-snap")
    man = read_manifest(path)
    cfg = jrestore.engine_config_from_manifest(man)
    assert cfg.tp == 2
    model_cfg = jrestore.model_config_from_manifest(man)
    params = jrestore.restore_params(man, path, model_cfg, cfg)
    jeng = JaxEngine(cfg, model_cfg=model_cfg, params=params)
    assert dict(jeng.mesh.shape)["tp"] == 2
    assert jeng.generate(PROMPTS, JaxSamplingParams(max_tokens=MAX_TOKENS)) == run["jax_want"]


@pytest.mark.parametrize("source", ["jax", "port"])
def test_tp2_snapshots_restore_in_the_port_at_tp2(run, source):
    lead = _lead(run)
    for out in run["outs"]:
        assert json.loads(str(out[f"{source}_restored_mesh"]))["tp"] == 2
    assert json.loads(str(lead[f"{source}_restored_tokens"])) == run["jax_want"]


def test_mesh_refusals_in_a_two_rank_job(run):
    for out in run["outs"]:
        msg = str(out["one_snapshot_refused"])
        assert "world size of 2" in msg and "1 rank(s)" in msg
        msg = str(out["gloo_graphs_refused"])
        assert "gloo" in msg and "cuda_graphs=False" in msg
