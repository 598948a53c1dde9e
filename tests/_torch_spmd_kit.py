"""Ranks of the port on the CPU for the ``test_torch_parallel_*`` tests.

``run_ranks`` starts ``world`` processes of this file, each one rank of a
gloo job on localhost (its own port), hands them a job's inputs as numpy
files, and returns what each rank wrote. A rank imports torch and the port
only: the JAX oracle runs in the test process. Every process group has a
timeout and every rank a wall-clock limit, so a hang fails the test.

Run as ``python tests/_torch_spmd_kit.py WORKDIR RANK WORLD PORT``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

from opsagent_tpu_torch.serving.spmd import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT_S = 30.0


def run_ranks(job: str, world: int, workdir, inputs: dict | None = None,
              params: dict | None = None, timeout: float = 120.0,
              env: dict[int, dict[str, str]] | None = None,
              expect_ok: bool = True, hosts: int = 0) -> list[dict]:
    """Run ``job`` on ``world`` ranks; returns each rank's outputs (a dict
    of arrays, plus ``"rc"`` and ``"stderr"``). With ``expect_ok`` a rank
    that fails or outlives ``timeout`` fails the call. ``hosts`` > 0
    launches the ranks as torch's multi-node launcher does, over that many
    "hosts" on localhost: ``MASTER_ADDR``/``MASTER_PORT``, the global
    ``RANK`` and ``WORLD_SIZE``, and ``LOCAL_RANK`` counted per host, from
    which each rank joins the job (``init_distributed()`` with no
    arguments)."""
    workdir = str(workdir)
    os.makedirs(workdir, exist_ok=True)
    np.savez(os.path.join(workdir, "inputs.npz"), **(inputs or {}))
    with open(os.path.join(workdir, "job.json"), "w") as f:
        json.dump({"name": job, **(params or {})}, f)
    port = free_port()
    procs = []
    for r in range(world):
        e = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
        e.pop("OPSAGENT_FAULTS", None)
        if hosts:
            e.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(r),
                     WORLD_SIZE=str(world), LOCAL_RANK=str(r % (world // hosts)))
        e.update((env or {}).get(r, {}))
        errf = open(os.path.join(workdir, f"stderr_{r}.txt"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), workdir, str(r), str(world),
             str(port)], env=e, stdout=errf, stderr=subprocess.STDOUT, cwd=REPO), errf))
    deadline = time.monotonic() + timeout
    outs = []
    for r, (p, errf) in enumerate(procs):
        try:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for q, _ in procs:
                q.kill()
            for q, _ in procs:
                q.wait()
        errf.close()
    for r, (p, _) in enumerate(procs):
        with open(os.path.join(workdir, f"stderr_{r}.txt")) as f:
            err = f.read()
        path = os.path.join(workdir, f"out_{r}.npz")
        out = dict(np.load(path, allow_pickle=False)) if os.path.exists(path) else {}
        out["rc"], out["stderr"] = p.returncode, err
        outs.append(out)
        if expect_ok and p.returncode != 0:
            raise AssertionError(f"rank {r} of {job} exited {p.returncode}:\n{err[-4000:]}")
    return outs


# -- the ranks' side ------------------------------------------------------------
def _t(a):
    import torch

    return torch.from_numpy(np.ascontiguousarray(a))


def _pages(inputs, prefix: str):
    """Pages from ``prefix``'s arrays: plain, or int8 QuantizedPages."""
    from opsagent_tpu_torch.ops.attention import QuantizedPages

    if f"{prefix}_scale" in inputs:
        return QuantizedPages(_t(inputs[prefix]), _t(inputs[f"{prefix}_scale"]))
    return _t(inputs[prefix])


def _heads(pages, mesh, axis="tp"):
    """This rank's kv heads of full pages (axis -2 of the values, -1 of the
    scale plane)."""
    from opsagent_tpu_torch.ops.attention import QuantizedPages
    from opsagent_tpu_torch.parallel.mesh import shard_tensor

    if isinstance(pages, QuantizedPages):
        return QuantizedPages(shard_tensor(pages.q, (None, None, axis, None), mesh),
                              shard_tensor(pages.scale, (None, None, axis), mesh))
    return shard_tensor(pages, (None, None, axis, None), mesh)


def job_attention(job, inputs, mesh):
    """The tp wrappers over this rank's heads, gathered over tp."""
    import torch

    from opsagent_tpu_torch.ops.paged_attention import (
        paged_decode_attention_tp,
        paged_ragged_attention_tp,
    )
    from opsagent_tpu_torch.parallel.collectives import all_gather
    from opsagent_tpu_torch.parallel.mesh import shard_tensor

    tp = mesh.shape["tp"]
    out = {}
    for spec in job["cases"]:
        case = spec["name"]
        dt = torch.bfloat16 if spec["bf16"] else torch.float32
        kp, vp = (_heads(_pages(inputs, f"{case}_{s}"), mesh) for s in ("k", "v"))
        if spec["bf16"]:
            kp, vp = kp.to(dt), vp.to(dt)
        table = _t(inputs[f"{case}_table"])
        contract = dict(tp=tp, num_heads=spec["heads"], num_kv_heads=spec["kv_heads"],
                        backend=spec["backend"])
        q = shard_tensor(_t(inputs[f"{case}_q"]).to(dt), (None, None, "tp", None), mesh)
        got = paged_ragged_attention_tp(q, kp, vp, table, _t(inputs[f"{case}_start"]),
                                        _t(inputs[f"{case}_q_lens"]), **contract)
        out[f"{case}_ragged"] = all_gather(got, mesh, "tp", dim=2).float().numpy()
        qd = shard_tensor(_t(inputs[f"{case}_qd"]).to(dt), (None, "tp", None), mesh)
        got = paged_decode_attention_tp(qd, kp, vp, table, _t(inputs[f"{case}_lengths"]),
                                        **contract)
        out[f"{case}_decode"] = all_gather(got, mesh, "tp", dim=1).float().numpy()
        # The shard contract: a rank holding the wrong heads raises.
        try:
            paged_decode_attention_tp(qd[:, :1], kp, vp, table,
                                      _t(inputs[f"{case}_lengths"]), **contract)
            out[f"{case}_bad_shard_raised"] = np.array(0)
        except ValueError:
            out[f"{case}_bad_shard_raised"] = np.array(1)
    torch.distributed.barrier()
    return out


def job_quant(job, inputs, mesh):
    """``quant_matmul_tp`` over this rank's columns, gathered over tp."""
    from opsagent_tpu_torch.models.quant import QuantizedLinear, QuantizedLinear4
    from opsagent_tpu_torch.ops.quant_matmul import quant_matmul_tp
    from opsagent_tpu_torch.parallel.collectives import all_gather
    from opsagent_tpu_torch.parallel.mesh import shard_tensor

    out = {}
    for mode in job["modes"]:
        q, scale = _t(inputs[f"{mode}_q"]), _t(inputs[f"{mode}_scale"])
        cls = QuantizedLinear4 if mode == "int4" else QuantizedLinear
        w = cls(shard_tensor(q, (None, "tp"), mesh),
                shard_tensor(scale, (None,) * (scale.ndim - 1) + ("tp",), mesh))
        y = quant_matmul_tp(_t(inputs["x"]), w)
        out[mode] = all_gather(y, mesh, "tp", dim=-1).numpy()
    return out


def job_ring(job, inputs, mesh):
    """``make_ring_attention`` over sp on whole sequences."""
    from opsagent_tpu_torch.parallel.ring import make_ring_attention

    ring = make_ring_attention(mesh)
    out = {}
    for case in job["cases"]:
        lengths = inputs.get(f"{case}_lengths")
        out[case] = ring(_t(inputs[f"{case}_q"]), _t(inputs[f"{case}_k"]),
                         _t(inputs[f"{case}_v"]),
                         None if lengths is None else _t(lengths)).numpy()
    return out


def job_collectives(job, inputs, mesh):
    """Each collective over each axis of a (sp, tp) mesh, on rank-valued
    tensors; and the host-staged transport counts (none: CPU tensors)."""
    import torch

    from opsagent_tpu_torch.parallel import collectives as c

    out = {}
    r = float(mesh.rank)
    for axis in ("sp", "tp"):
        x = torch.full((2, 3), r)
        out[f"{axis}_sum"] = c.all_reduce_sum(x, mesh, axis).numpy()
        out[f"{axis}_gather"] = c.all_gather(x[:1], mesh, axis, dim=0).numpy()
        out[f"{axis}_bcast"] = c.broadcast(x, mesh, axis, src=1).numpy()
        n = mesh.shape[axis]
        out[f"{axis}_ring"] = c.ppermute(x, mesh, axis, [(j, (j + 1) % n) for j in range(n)]
                                         ).numpy()
        out[f"{axis}_partial"] = c.ppermute(x, mesh, axis, [(0, 1)]).numpy()
        out[f"{axis}_input_unchanged"] = np.array(bool((x == r).all()))
    out["staged"] = np.array(sum(c.HOST_STAGED.values()))
    return out


def _model(job, inputs, mesh):
    import torch

    from opsagent_tpu_torch.models.config import get_config_preset
    from opsagent_tpu_torch.models.llama import Llama

    cfg = get_config_preset(job["model"])
    if job.get("all_experts") and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, grouped_dispatch_min_tokens=0))
    model = Llama(cfg, torch.float32, "cpu", seed=None, quantize=job.get("quantize", ""),
                  mesh=mesh)
    state = {k.removeprefix("state/"): _t(v) for k, v in inputs.items()
             if k.startswith("state/")}
    model.load_full_state_dict(state)
    return model


def job_model(job, inputs, mesh):
    """Prefill, two mixed steps and a decode step over a paged cache: each
    step's logits and the rank's cache shard."""
    import torch

    model = _model(job, inputs, mesh)
    cache = model.make_cache(job["pages"], job["page_size"], job.get("kv_quantize", ""))
    table = _t(inputs["table"])
    out = {}
    with torch.inference_mode():
        out["prefill"] = model.prefill(_t(inputs["prefill_tokens"]).long(),
                                       _t(inputs["prefill_lens"]), cache, table).numpy()
        for i in range(2):
            out[f"mixed{i}"] = model.mixed_step(
                _t(inputs[f"mixed{i}_tokens"]).long(), _t(inputs[f"mixed{i}_start"]),
                _t(inputs[f"mixed{i}_q_lens"]), cache, table).numpy()
        out["decode"] = model.decode_step(
            _t(inputs["decode_tokens"]).long(), _t(inputs["decode_lengths"]), cache, table,
            _t(inputs["decode_active"])).numpy()
    for name, leaf in cache.page_leaves().items():
        out[f"cache/{name}"] = leaf.numpy()
    return out


def _engine_config(job):
    import torch

    from opsagent_tpu_torch.serving.engine import EngineConfig

    kw = dict(job["engine"])
    kw["dtype"] = torch.float32
    for key in ("prefill_buckets", "mixed_buckets"):
        if key in kw:
            kw[key] = tuple(kw[key])
    return EngineConfig(device="cpu", cuda_graphs=False, **kw)


def _engine(job, inputs, mesh):
    from opsagent_tpu_torch.serving.engine import Engine

    model = _model(job, inputs, mesh) if any(k.startswith("state/") for k in inputs) else None
    return Engine(_engine_config(job), model=model)


def drive(engine, prompts, sp, split_lane=False):
    """Admit the first prompt alone, the rest in mixed ticks beside the
    decode lanes of those before (or each through the split lane), then
    block-decode all, with sampling parameters ``sp``: each prompt's
    tokens. The JAX engine takes the same calls."""
    ids = []
    for prompt in prompts:
        sid = engine.begin_request(prompt, sp)
        while True:
            if split_lane:
                if engine.prefill_step(sid):
                    break
                continue
            done, total = engine.prefill_progress(sid)
            running = [s for s in ids if not engine.sequences[s].done]
            _, out = engine.step_mixed(running, {sid: total - done})
            if out[sid] is True:
                break
        ids.append(sid)
    while any(not engine.sequences[s].done for s in ids):
        engine.step_block([s for s in ids if not engine.sequences[s].done])
    return [engine.finish(s) for s in ids]


def _sampling(job):
    from opsagent_tpu_torch.serving.sampler import SamplingParams

    return SamplingParams(max_tokens=job["max_tokens"])


def job_engine(job, inputs, mesh):
    """A lockstep engine: the leader drives the prompts, the followers
    follow; every rank returns the outputs of every op it ran."""
    engine = _engine(job, inputs, mesh)
    engine.spmd_outputs = []
    out = {}
    if mesh.leader:
        prompts = json.loads(job["prompts"])
        tokens = drive(engine, prompts, _sampling(job), job.get("split_lane", False))
        engine.stop_followers()
        out["tokens"] = np.array(json.dumps(tokens))
    else:
        out["ops_run"] = np.array(engine.follow())
    from opsagent_tpu_torch.serving.spmd import on_host

    ops = on_host(engine.spmd_outputs)
    out["op_names"] = np.array(json.dumps([op for op, _ in ops]))
    for i, (_, arrays) in enumerate(ops):
        for j, a in enumerate(arrays):
            out[f"op{i}_{j}"] = a
    out["mixed_eager_ticks"] = np.array(engine.mixed_eager_ticks)
    out["decode_eager_steps"] = np.array(engine.decode_eager_steps)
    return out


def job_follower_fails(job, inputs, mesh):
    """Rank 1's follower raises (a fault point) on its first op; the leader
    must raise from a collective, not hang. The leader reports the
    exception and the seconds it took."""
    engine = _engine(job, inputs, mesh)
    if not mesh.leader:
        engine.follow()
        return {}
    t0 = time.monotonic()
    try:
        drive(engine, json.loads(job["prompts"]), _sampling(job))
        return {"raised": np.array(0), "seconds": np.array(time.monotonic() - t0)}
    except Exception as e:  # noqa: BLE001 - the check reports it
        return {"raised": np.array(1), "seconds": np.array(time.monotonic() - t0),
                "error": np.array(f"{type(e).__name__}: {e}"[:500])}


def _run(engine, prompt, max_tokens):
    """Admit ``prompt`` alone, then decode it: its greedy tokens (the
    sequence finished, its pages donated to the trie)."""
    from opsagent_tpu_torch.serving.sampler import SamplingParams

    sid = engine.begin_request(list(prompt), SamplingParams(max_tokens=max_tokens))
    while sid in engine._prefilling:
        engine.step_mixed([], {sid: engine.cfg.mixed_buckets[-1]})
    while not engine.sequences[sid].done:
        engine.step_block([sid])
    engine.drain()
    return engine.finish(sid)


class _Peer:
    """A replica handle of another process for ``migrate_chain``: it
    exports the records it was given and keeps the records it imports."""

    replica_id = "peer"

    def __init__(self, records=None):
        self.records, self.imported = records or [], []

    def export_pages(self, token_ids, park=True):
        return self.records

    def import_pages(self, records):
        self.imported = records
        return len(records)


def job_mesh_state(job, inputs, mesh):
    """The serve path's state at a tp = 2 mesh, one engine after another on
    every rank (the leader drives, the followers follow):

    1. the host tier: a session served, parked (``park_chain``) and
       continued from the restored pages; the pool's whole pages; a
       session migrated out (``migrate_chain`` from this replica) and one
       migrated in from a one-rank engine's records, and one from the JAX
       engine's, each continued; then a snapshot written at the mesh;
    2. the JAX package's tp = 2 snapshot restored here, and
    3. the snapshot of 1 restored here, each serving ``prompts``;
    4. a snapshot of int4 weights whose scale groups shard with their
       rows (``q4/`` inputs);
    5. refusals: a one-rank snapshot in this two-rank job, CUDA graphs
       over gloo."""
    import torch

    from opsagent_tpu_torch.serving.api import ServingStack
    from opsagent_tpu_torch.serving.engine import Engine
    from opsagent_tpu_torch.serving.fleet.router import LocalReplica
    from opsagent_tpu_torch.serving.fleet.transfer import migrate_chain
    from opsagent_tpu_torch.serving.sampler import SamplingParams
    from opsagent_tpu_torch.serving.snapshot import SnapshotError

    out = {}
    prompts = json.loads(job["prompts"])
    greedy = SamplingParams(max_tokens=job["max_tokens"])
    engine = _engine(job, inputs, mesh)
    if mesh.leader:
        parked = job["parked"]
        first = _run(engine, parked, job["max_tokens"])
        hist = parked + first[:-1]
        out["first"] = np.array(json.dumps(first))
        stack = ServingStack(engine)
        try:
            peer = _Peer()
            out["migrated_out"] = np.array(migrate_chain(LocalReplica(stack, "tp2"), peer,
                                                         hist, "test"))
            entries = engine.offload.pool.match(hist)
            for j, e in enumerate(entries):
                for name, t in e.data.items():
                    out[f"pool/{j}/{name}"] = t.numpy()
            out["records"] = np.array(json.dumps(peer.imported))
            before = engine.offload.restored_pages
            out["continued"] = np.array(json.dumps(_run(engine, hist + job["turn"],
                                                        job["max_tokens"])))
            out["restored_pages"] = np.array(engine.offload.restored_pages - before)
            for name in ("one", "jax"):
                records = json.loads(str(inputs[f"{name}_records"]))
                before = engine.offload.restored_pages
                n = migrate_chain(_Peer(records), LocalReplica(stack, "tp2"),
                                  records[-1]["tokens"], "test")
                hist_in = list(records[-1]["tokens"])
                out[f"{name}_imported"] = np.array(n)
                out[f"{name}_continued"] = np.array(json.dumps(
                    _run(engine, hist_in + job["turn"], job["max_tokens"])))
                out[f"{name}_restored_pages"] = np.array(
                    engine.offload.restored_pages - before)
        finally:
            stack.close()
        man = engine.snapshot(job["port_snapshot"])
        out["snapshot_mesh"] = np.array(json.dumps(man["torch"]["mesh"]))
        engine.stop_followers()
    else:
        out["ops_run"] = np.array(engine.follow())
        out["follower_pool_pages"] = np.array(engine.offload.pool.num_pages)
    del engine
    for name in ("jax", "port"):
        restored = Engine.from_snapshot(job[f"{name}_snapshot"], device="cpu", eager=True)
        out[f"{name}_restored_mesh"] = np.array(json.dumps(restored.mesh.describe()))
        if mesh.leader:
            out[f"{name}_restored_tokens"] = np.array(json.dumps(
                restored.generate(prompts, greedy)))
            restored.stop_followers()
        else:
            restored.follow()
        del restored
    from opsagent_tpu_torch.models.config import get_config_preset
    from opsagent_tpu_torch.models.llama import Llama

    model = Llama(get_config_preset(job["model"]), torch.float32, "cpu", seed=None,
                  quantize="int4", mesh=mesh)
    model.load_full_state_dict({k.removeprefix("q4/"): _t(v) for k, v in inputs.items()
                                if k.startswith("q4/")})
    out["int4_split_scales"] = np.array(len(model._split_scales))
    engine = Engine(dataclasses.replace(_engine_config(job), quantize="int4"), model=model)
    if mesh.leader:
        engine.snapshot(job["int4_snapshot"])
        engine.stop_followers()
    else:
        engine.follow()
    del engine, model
    try:
        Engine.from_snapshot(job["one_snapshot"], device="cpu", eager=True)
        out["one_snapshot_refused"] = np.array("")
    except SnapshotError as e:
        out["one_snapshot_refused"] = np.array(str(e)[:300])
    try:
        Engine(dataclasses.replace(_engine_config(job), cuda_graphs=True))
        out["gloo_graphs_refused"] = np.array("")
    except ValueError as e:
        out["gloo_graphs_refused"] = np.array(str(e)[:300])
    torch.distributed.barrier()
    return out


def job_refusals(job, inputs, mesh):
    """What a mesh engine refuses, each as 1 (raised) or 0: CUDA graphs
    over gloo only. The host tier, a snapshot and a migration run (the
    leader drives the snapshot while the follower follows)."""
    import torch

    from opsagent_tpu_torch.serving.engine import Engine, EngineConfig
    from opsagent_tpu_torch.serving.fleet.transfer import migrate_chain

    base = EngineConfig(model="tiny-test", dtype=torch.float32, device="cpu",
                        num_pages=32, max_pages_per_seq=8, page_size=4,
                        max_batch_size=2, cuda_graphs=False, tp=job["tp"])
    out = {}

    def raises(name, fn):
        try:
            fn()
            out[name] = np.array(0)
        except ValueError as e:
            out[name] = np.array(1)
            out[f"{name}_msg"] = np.array(str(e)[:300])

    raises("cuda_graphs", lambda: Engine(dataclasses.replace(base, cuda_graphs=True)))
    engine = Engine(dataclasses.replace(base, offload=True))
    out["offload"] = np.array(int(engine.offload is None))
    path = os.path.join(job["workdir"], "snap")
    if mesh.leader:
        raises("snapshot", lambda: engine.snapshot(path))
        out["snapshot_written"] = np.array(int(os.path.exists(
            os.path.join(path, "manifest.json"))))

        class Handle:
            replica_id = "r0"

            class stack:  # noqa: N801 - the replica handle's shape
                pass

        Handle.stack.engine = engine
        raises("migrate", lambda: migrate_chain(Handle(), Handle(), [1, 2, 3], "test"))
        from opsagent_tpu_torch.serving.api import ServingStack
        from opsagent_tpu_torch.serving.fleet.client import FleetMembership
        from opsagent_tpu_torch.serving.fleet.router import LocalReplica

        # The mesh a replica registers, in-process and over HTTP.
        stack = ServingStack(engine)
        try:
            out["local_mesh"] = np.array(json.dumps(LocalReplica(stack, "r0").info().mesh))
            member = FleetMembership(stack, "http://127.0.0.1:9", "http://127.0.0.1:9")
            out["member_mesh"] = np.array(json.dumps(member._payload(full=True)["mesh"]))
        finally:
            stack.close()
        engine.stop_followers()
    else:
        engine.follow()
    return out


def _train_config(spec: dict):
    """A preset with overrides (``{"preset": ..., "change": {...}}``; a
    ``moe`` change is a ``MoEConfig``'s fields)."""
    from opsagent_tpu_torch.models.config import MoEConfig, get_config_preset

    change = dict(spec.get("change", {}))
    if "moe" in change:
        change["moe"] = MoEConfig(**change["moe"])
    return dataclasses.replace(get_config_preset(spec["preset"]), **change)


def _train_state(case, inputs, mesh, seed=None):
    """(model, optimizer) of a train case at ``mesh`` (None: one rank):
    the case's weights (``w/<weights>/...``), or drawn from ``seed``."""
    import torch

    from opsagent_tpu_torch.models.llama import Llama
    from opsagent_tpu_torch.training import TrainConfig, init_train_state

    cfg = _train_config(case["model"])
    tc = TrainConfig(**case["tc"])
    if seed is not None:
        return init_train_state(cfg, tc, seed=seed, dtype=torch.float32, device="cpu",
                                mesh=mesh)
    prefix = f"w/{case['weights']}/"
    model = Llama(cfg, torch.float32, "cpu", seed=None, mesh=mesh)
    model.load_full_state_dict({k.removeprefix(prefix): _t(v) for k, v in inputs.items()
                                if k.startswith(prefix)})
    return init_train_state(cfg, tc, model=model)


def _train_mesh(shape: dict, timeout_s: float = GROUP_TIMEOUT_S):
    from opsagent_tpu_torch.parallel import mesh as pmesh

    return pmesh.make_mesh(tp=shape.get("tp", 1), dp=shape.get("dp", 1),
                           sp=shape.get("sp", 1), pp=shape.get("pp", 1),
                           ep=shape.get("ep", 1), timeout_s=timeout_s)


def _record(out: dict, label: str, metrics: list, model, opt) -> None:
    """The metrics of each step, the rank's shards after the last, and
    AdamW's first moment of each shard."""
    for key in ("loss", "moe_aux", "grad_norm"):
        out[f"{label}/{key}"] = np.array([float(m[key]) for m in metrics])
    for k, v in model.named_parameters():
        out[f"{label}/state/{k}"] = v.detach().numpy()
        out[f"{label}/mu/{k}"] = opt.state[v]["exp_avg"].numpy()


def _batches(case, inputs):
    return [(_t(inputs[f"batch/{b}/tokens"]), _t(inputs[f"batch/{b}/mask"]))
            for b in case["batches"]]


def job_train(job, inputs, mesh):
    """Each train case in turn, every rank making its mesh's groups in one
    order: the case's steps from its weights at its mesh (every rank given
    the whole batch), its metrics and the rank's shards after them. Then
    the ring's q/k/v gradients, a checkpoint resumed at other meshes, and
    a step whose peer is lost (the rank past ``lost_peer`` leaves)."""
    import torch

    from opsagent_tpu_torch.parallel.ring import make_ring_attention
    from opsagent_tpu_torch.training import (
        TrainConfig,
        make_train_step,
        restore_train_state,
        save_train_state,
    )

    out = {}
    if "launch" in job:
        out["launch/world"] = np.array(job["launch"]["world"])
        out["launch/local_rank"] = np.array(job["launch"]["local_rank"])
        out["launch/rank"] = np.array(torch.distributed.get_rank())
    for case in job.get("cases", []):
        t0 = time.monotonic()
        m = _train_mesh(case["mesh"])
        model, opt = _train_state(case, inputs, m)
        step = make_train_step(model.cfg, TrainConfig(**case["tc"]))
        metrics = [step(model, opt, tokens, mask) for tokens, mask in _batches(case, inputs)]
        _record(out, case["name"], metrics, model, opt)
        out[f"{case['name']}/seconds"] = np.array(time.monotonic() - t0)
    for case in job.get("ring_grads", []):
        m = _train_mesh({"sp": case["sp"]})
        q, k, v = (_t(inputs[f"{case['name']}/{n}"]).requires_grad_() for n in "qkv")
        lengths = inputs.get(f"{case['name']}/lengths")
        o = make_ring_attention(m)(q, k, v, None if lengths is None else _t(lengths))
        (o * o).sum().backward()
        for n, t in zip("qkv", (q, k, v)):
            out[f"{case['name']}/d{n}"] = t.grad.numpy()
    if "checkpoint" in job:
        case = job["checkpoint"]
        where = os.path.join(job["workdir"], "ckpt")
        cfg = _train_config(case["model"])
        step = make_train_step(cfg, TrainConfig(**case["tc"]))
        (t0, m0), (t1, m1) = _batches(case, inputs)
        model, opt = _train_state(case, inputs, _train_mesh(case["save_mesh"]))
        first = step(model, opt, t0, m0)
        save_train_state(where, 1, model, opt)
        _record(out, "ckpt/uninterrupted", [first, step(model, opt, t1, m1)], model, opt)
        model, opt = _train_state(case, inputs, _train_mesh(case["restore_mesh"]), seed=11)
        _, _, at = restore_train_state(where, model, opt)
        _record(out, "ckpt/resumed", [step(model, opt, t1, m1)], model, opt)
        out["ckpt/at"] = np.array(at)
        if torch.distributed.get_rank() == 0:
            model, opt = _train_state(case, inputs, None, seed=11)
            restore_train_state(where, model, opt)
            _record(out, "ckpt/one_rank", [step(model, opt, t1, m1)], model, opt)
        torch.distributed.barrier()
    if "lost_peer" in job:
        case = job["lost_peer"]
        m = _train_mesh(case["mesh"], timeout_s=case["timeout_s"])
        if m.rank == 0:
            model, opt = _train_state(case, inputs, m)
            step = make_train_step(model.cfg, TrainConfig(**case["tc"]))
            t0 = time.monotonic()
            try:
                step(model, opt, *_batches(case, inputs)[0])
                out["lost/raised"] = np.array(0)
            except Exception as e:  # noqa: BLE001 - the check reports it
                out["lost/raised"] = np.array(1)
                out["lost/error"] = np.array(f"{type(e).__name__}: {e}"[:300])
            out["lost/seconds"] = np.array(time.monotonic() - t0)
    return out


JOBS = {
    "attention": job_attention, "quant": job_quant, "ring": job_ring,
    "collectives": job_collectives,
    "model": job_model, "engine": job_engine, "follower_fails": job_follower_fails,
    "refusals": job_refusals, "mesh_state": job_mesh_state, "train": job_train,
}


def main(workdir: str, rank: int, world: int, port: int) -> int:
    from opsagent_tpu_torch.parallel import mesh as pmesh

    with open(os.path.join(workdir, "job.json")) as f:
        job = json.load(f)
    job["workdir"] = workdir
    inputs = dict(np.load(os.path.join(workdir, "inputs.npz")))
    pmesh.GROUP_TIMEOUT_S = GROUP_TIMEOUT_S
    if "RANK" in os.environ:
        joined = pmesh.init_distributed(backend="gloo", timeout_s=GROUP_TIMEOUT_S)
        job["launch"] = {"world": joined, "local_rank": pmesh.local_rank()}
    else:
        pmesh.init_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo",
                               timeout_s=GROUP_TIMEOUT_S)
    shape = job.get("mesh", {"tp": world})
    mesh = pmesh.make_mesh(tp=shape.get("tp", 1), dp=shape.get("dp", 1),
                           sp=shape.get("sp", 1), ep=shape.get("ep", 1),
                           timeout_s=GROUP_TIMEOUT_S)
    out = JOBS[job["name"]](job, inputs, mesh)
    np.savez(os.path.join(workdir, f"out_{rank}.npz"), **out)
    # Tear the groups down here, not in the interpreter's exit.
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])))
