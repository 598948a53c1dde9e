"""The port's engine snapshots (``serving/snapshot``) against the JAX
package's on the CPU.

- The port's spec leaf paths equal JAX's ``spec_leaf_paths`` for tiny-test,
  tiny-moe and tiny-mla, unquantized, int8 and int4.
- A JAX-written tiny-test snapshot restores in the port with the JAX
  engine's greedy tokens (f32, and int8 weights + int8 KV); the port's
  snapshot passes JAX's ``verify_snapshot``, and its leaf files restore in
  the JAX package (``restore_params``) to the port's greedy tokens.
- A port snapshot round-trips with identical greedy tokens and identical
  weights, int8 and int4 weights too (no second quantization), and so does
  a model whose every layer is a MoE layer (an empty dense stack).
- A flipped byte, an edited config, a leaf-order drift, a truncated leaf,
  a card-count mismatch and a snapshot written at a mesh larger than the
  job are each refused (the JAX package's ``tests/test_snapshot.py``
  cases).
- The kernel libraries: ``snapshot create`` copies the built ones into
  ``compile-cache/`` and a restore copies them back; ``snapshot verify``
  exits 0 / 1 / 2.
"""

import os
from dataclasses import replace

import jax.numpy as jnp
import pytest
import torch

from opsagent_tpu.models.config import get_config_preset as jax_preset
from opsagent_tpu.serving.engine import Engine as JaxEngine
from opsagent_tpu.serving.engine import EngineConfig as JaxEngineConfig
from opsagent_tpu.serving.sampler import SamplingParams as JaxSamplingParams
from opsagent_tpu.serving.snapshot import restore as jrestore
from opsagent_tpu.serving.snapshot import verify_snapshot as jax_verify
from opsagent_tpu.serving.snapshot.writer import spec_leaf_paths as jax_spec_leaf_paths
from opsagent_tpu_torch import __main__ as cli
from opsagent_tpu_torch import obs as pobs
from opsagent_tpu_torch.models.config import get_config_preset
from opsagent_tpu_torch.models.convert import spec_leaf_paths
from opsagent_tpu_torch.ops import cuda_build
from opsagent_tpu_torch.serving.engine import Engine, EngineConfig
from opsagent_tpu_torch.serving.sampler import SamplingParams
from opsagent_tpu_torch.serving.snapshot import SnapshotError, verify_snapshot
from opsagent_tpu_torch.serving.snapshot.manifest import fingerprint, read_manifest, write_manifest
from opsagent_tpu_torch.serving.snapshot.restore import preseed_kernels

BASE = dict(page_size=4, num_pages=64, max_pages_per_seq=16, max_batch_size=4,
            decode_block=4, mixed_buckets=(4, 8, 16), max_step_tokens=32)
PROMPTS = [list(range(1, 13)), list(range(40, 54))]


@pytest.fixture(autouse=True)
def reset_port_obs():
    pobs.get_registry().reset()
    pobs.flight.get_recorder().reset()
    yield
    pobs.get_registry().reset()


def _engine(**over) -> Engine:
    return Engine(EngineConfig(model="tiny-test", dtype=torch.float32, device="cpu",
                               **{**BASE, **over}))


def _greedy(eng) -> list[list[int]]:
    return eng.generate(PROMPTS, SamplingParams(max_tokens=8))


def _snap(tmp_path, **over):
    eng = _engine(**over)
    path = str(tmp_path / "snap")
    return eng, path, eng.snapshot(path)


@pytest.mark.parametrize("quantize", ["", "int8", "int4"])
@pytest.mark.parametrize("model", ["tiny-test", "tiny-moe", "tiny-mla"])
def test_spec_leaf_paths_equal_jax(model, quantize):
    assert spec_leaf_paths(get_config_preset(model), quantize) == jax_spec_leaf_paths(
        jax_preset(model), quantize)


@pytest.mark.parametrize("quantize", ["", "int8"])
def test_jax_snapshot_restores_in_the_port(tmp_path, quantize):
    kw = dict(model="tiny-test", dtype=jnp.float32, tp=1, prefill_buckets=(16,), seed=0,
              quantize=quantize, kv_quantize=quantize, **{k: v for k, v in BASE.items()
                                                         if k != "mixed_buckets"})
    jeng = JaxEngine(JaxEngineConfig(**kw))
    want = jeng.generate(PROMPTS, JaxSamplingParams(max_tokens=8))
    path = str(tmp_path / "jax-snap")
    jeng.snapshot(path)
    eng = Engine.from_snapshot(path, device="cpu")
    assert eng.cfg.quantize == quantize and eng.cfg.kv_quantize == quantize
    assert eng.init_stats["snapshot_fingerprint"] == read_manifest(path)["fingerprint"]
    assert _greedy(eng) == want
    assert pobs.SNAPSHOT_OPS.value(op="restore") == 1


def test_port_snapshot_verifies_and_restores_in_jax(tmp_path):
    eng, path, man = _snap(tmp_path)
    want = _greedy(eng)
    for verify in (jax_verify, verify_snapshot):
        rep = verify(path)
        assert rep["ok"] and not rep["errors"], rep
        assert rep["leaves_ok"] == len(man["leaves"])
    # The same leaf files restore in the JAX package.
    cfg = jrestore.engine_config_from_manifest(man)
    model_cfg = jrestore.model_config_from_manifest(man)
    params = jrestore.restore_params(man, path, model_cfg, cfg)
    jeng = JaxEngine(JaxEngineConfig(**{**cfg.__dict__, "prefill_buckets": (16,)}),
                     model_cfg=model_cfg, params=params)
    assert jeng.generate(PROMPTS, JaxSamplingParams(max_tokens=8)) == want


def test_split_lane_settings_cross_both_ways(tmp_path):
    """``mixed_batching``, ``prefill_batch`` and ``prefill_buckets`` travel
    in the manifest's engine block: a JAX snapshot with mixed batching off
    restores into a port engine that admits through the split prefill lane,
    with the JAX engine's greedy tokens; a port snapshot with it off reads
    back as such in the JAX package and in the port, and restores in the
    JAX package to the port's tokens."""
    lane = dict(mixed_batching=False, prefill_batch=2, prefill_buckets=(8, 16))
    kw = dict(model="tiny-test", dtype=jnp.float32, tp=1, seed=0, **lane,
              **{k: v for k, v in BASE.items() if k != "mixed_buckets"})
    jeng = JaxEngine(JaxEngineConfig(**kw))
    want = jeng.generate(PROMPTS, JaxSamplingParams(max_tokens=8))
    path = str(tmp_path / "jax-snap")
    jeng.snapshot(path)
    eng = Engine.from_snapshot(path, device="cpu")
    assert {k: getattr(eng.cfg, k) for k in lane} == lane
    assert _greedy(eng) == want
    assert eng.prefill_dispatches > 0 and eng.mixed_eager_ticks == 0
    eng, path, man = _snap(tmp_path, **lane)
    ours = _greedy(eng)
    assert man["engine"]["prefill_buckets"] == [8, 16]
    assert man["engine"]["mixed_batching"] is False and man["engine"]["prefill_batch"] == 2
    cfg = jrestore.engine_config_from_manifest(man)
    assert {k: getattr(cfg, k) for k in lane} == lane
    restored = Engine.from_snapshot(path, device="cpu")
    assert {k: getattr(restored.cfg, k) for k in lane} == lane
    params = jrestore.restore_params(man, path, jrestore.model_config_from_manifest(man), cfg)
    jeng = JaxEngine(cfg, model_cfg=jrestore.model_config_from_manifest(man), params=params)
    assert jeng.generate(PROMPTS, JaxSamplingParams(max_tokens=8)) == ours


@pytest.mark.parametrize("quantize", ["", "int8", "int4"])
def test_port_snapshot_round_trip(tmp_path, quantize):
    eng, path, man = _snap(tmp_path, quantize=quantize, kv_quantize="int8" if quantize else "")
    want = _greedy(eng)
    assert len(man["leaves"]) == len(spec_leaf_paths(eng.model_cfg, quantize))
    restored = Engine.from_snapshot(path, device="cpu")
    before, after = eng.model.state_dict(), restored.model.state_dict()
    assert before.keys() == after.keys()
    for k in before:
        assert torch.equal(before[k], after[k]), k   # codes not re-quantized
    assert _greedy(restored) == want
    assert restored.init_stats["restore_source"] == os.path.abspath(path)


def test_all_moe_model_round_trip(tmp_path):
    """Every layer a MoE layer (Qwen3-MoE's layout): JAX's tree keeps an
    empty dense stack, written as leaves with a leading 0."""
    cfg = replace(get_config_preset("tiny-moe"), moe_layer_start=0)
    assert spec_leaf_paths(cfg) == jax_spec_leaf_paths(
        replace(jax_preset("tiny-moe"), moe_layer_start=0), "")
    eng = Engine(EngineConfig(model=cfg.name, dtype=torch.float32, device="cpu", **BASE),
                 model_cfg=cfg)
    path = str(tmp_path / "moe-snap")
    man = eng.snapshot(path)
    empty = [r for r in man["leaves"] if r["path"].startswith("['layers']")]
    assert empty and all(r["shape"][0] == 0 and r["nbytes"] == 0 for r in empty)
    assert verify_snapshot(path)["ok"]
    assert _greedy(Engine.from_snapshot(path, device="cpu")) == _greedy(eng)


def test_flipped_byte_and_edited_config_fail_verify(tmp_path):
    _eng, path, man = _snap(tmp_path)
    fpath = os.path.join(path, man["leaves"][3]["file"])
    with open(fpath, "r+b") as f:
        b = f.read(1)
        f.seek(0)
        f.write(bytes([b[0] ^ 0xFF]))
    rep = verify_snapshot(path)
    assert not rep["ok"] and any("digest" in e for e in rep["errors"])
    assert verify_snapshot(path, quick=True)["ok"]
    man["engine"]["page_size"] = 8
    write_manifest(path, man)
    rep = verify_snapshot(path)
    assert not rep["ok"] and not rep["fingerprint_ok"]
    with pytest.raises(SnapshotError, match="fingerprint"):
        Engine.from_snapshot(path, device="cpu")
    assert pobs.SNAPSHOT_OPS.value(op="refused") == 1


def test_leaf_order_drift_truncation_and_device_counts_refused(tmp_path):
    _eng, path, man = _snap(tmp_path)
    drifted = dict(man, leaves=[man["leaves"][1], man["leaves"][0], *man["leaves"][2:]])
    write_manifest(path, drifted)
    with pytest.raises(SnapshotError, match="leaf order"):
        Engine.from_snapshot(path, device="cpu")
    write_manifest(path, dict(man, torch={**man["torch"], "count": 2}))
    with pytest.raises(SnapshotError, match="cards"):
        Engine.from_snapshot(path, device="cpu")
    sharded = dict(man, engine={**man["engine"], "tp": 2})
    sharded["fingerprint"] = fingerprint(sharded["model"], sharded["engine"])
    write_manifest(path, sharded)
    with pytest.raises(SnapshotError, match="world size of 1"):
        Engine.from_snapshot(path, device="cpu")
    write_manifest(path, man)
    fpath = os.path.join(path, man["leaves"][0]["file"])
    with open(fpath, "r+b") as f:
        f.truncate(os.path.getsize(fpath) - 4)
    with pytest.raises(SnapshotError, match="truncated"):
        Engine.from_snapshot(path, device="cpu")
    assert pobs.SNAPSHOT_OPS.value(op="refused") == 4


def test_kernel_libraries_travel_with_the_snapshot(tmp_path, monkeypatch):
    """The built libraries of the current sources go into compile-cache/
    and come back into an empty kernel directory, named as the build names
    them (so the restored engine's first build finds them)."""
    built = tmp_path / "kernels"
    monkeypatch.setattr(cuda_build, "BUILD_DIR", built)
    built.mkdir()
    libs = [cuda_build.library_path(s.name) for s in sorted(cuda_build.CSRC.glob("*.cu"))]
    for lib in libs:
        lib.write_bytes(b"\x7fELF " + lib.name.encode())
    (built / "libstale_0000.so").write_bytes(b"old")
    _eng, path, man = _snap(tmp_path)
    assert man["compile_cache"]["entries"] == len(libs)
    assert sorted(os.listdir(os.path.join(path, "compile-cache"))) == sorted(p.name for p in libs)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "fresh")
    assert preseed_kernels(path) == len(libs)
    assert preseed_kernels(path) == 0
    assert cuda_build.built_libraries() == [
        tmp_path / "fresh" / p.name for p in libs]
    assert verify_snapshot(path)["compile_cache_entries"] == len(libs)


def test_snapshot_cli_create_and_verify_exit_codes(tmp_path, capsys):
    path = str(tmp_path / "cli-snap")
    assert cli.main(["snapshot", "create", "--out", path, "--device", "cpu",
                     "--model-name", "tiny-test"]) == 0
    assert cli.main(["snapshot", "verify", path]) == 0
    man = read_manifest(path)
    with open(os.path.join(path, man["leaves"][0]["file"]), "ab") as f:
        f.write(b"\0")
    assert cli.main(["snapshot", "verify", path, "--quick"]) == 1
    assert cli.main(["snapshot", "verify", str(tmp_path / "none")]) == 2
    out = capsys.readouterr().out
    assert man["fingerprint"] in out
