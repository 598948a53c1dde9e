"""Command line: ``python -m opsagent_tpu_torch serve-engine --model-name
bench-8b --port 8000`` serves OpenAI chat completions from the port's engine
on the GPU (``--device cpu`` for the CPU); ``--checkpoint DIR --model-name
auto`` serves an HF safetensors checkpoint with its own config.json (model
types llama, mistral, qwen2, qwen3, qwen3_moe, deepseek, deepseek_v2 and
deepseek_v3), and its ``tokenizer.json`` when the directory holds one (``--tokenizer DIR``
names another; without either, the byte tokenizer). The
engine warms up (kernels built, its decode step and mixed ticks captured as
CUDA graphs on the GPU) before the server starts. Mixed ticks run one tick
ahead of their commit (``--async-depth 1`` serves them synchronously). The
server runs the SLO
watchdog and the 1 Hz telemetry history sampler behind ``/api/slo`` and
``/api/metrics/history``; ``--profile-dir`` enables the profiling routes
(``/api/debug/profile``, ``/api/debug/memory``, ``/v1/profile/*``).
``--offload`` adds the host KV tier (``--host-pool-bytes``,
``--offload-copy-pages``); ``--restore-snapshot DIR`` serves an engine
restored from a snapshot. ``--join-fleet URL`` registers the replica with a
fleet router (``--advertise``, ``--replica-id``, ``--replica-role
decode|prefill|standby``), heartbeats its load and prefix digests, and with
``--offload`` faults missing prefix chains in from peer replicas.

Several ranks serve one model in lockstep (``serving/spmd.py``): ``--tp``,
``--sp`` and ``--ep`` shape the mesh (tensor-parallel heads and columns,
ring-attention prefill, expert-parallel experts; ``--tp 0`` takes every
rank the others leave), ``--dist-backend`` picks the process groups'
backend (``nccl`` between cards, ``gloo`` on the CPU or for ranks sharing
a card), and ``--eager`` runs the steps without CUDA graphs, which a gloo
mesh with collectives requires (over NCCL, a card a rank, the steps are
captured with their collectives inside). Launch the ranks under torch's launch variables
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``;
``torchrun --nproc-per-node 2 -m opsagent_tpu_torch serve-engine --tp 2
--eager``), or with ``--nproc N``, which spawns the N ranks itself. Rank 0
binds the port and joins the fleet; the others follow its steps.

``python -m opsagent_tpu_torch serve-router --port 8090`` runs the fleet
router (``serving/fleet/router.py``): sessions spread over the replicas
that join it by prefix affinity, then least load, with sticky pinning,
queue spill-over with page migration, drain, retries, failover, hedging and
shedding (``--queue-spill``, ``--prefill-threshold``, ``--max-retries``,
``--hedge-queue-depth``, ``--shed-queue-depth``, ``--heartbeat-ttl``;
``--tokenizer`` and ``--model-name`` must match the replicas'), and with
``--autoscale-snapshot DIR`` launches standby replicas from that snapshot on
shed pressure (``--autoscale-max-replicas``, ``--autoscale-port-base``,
``--autoscale-cooldown``; ``serving/fleet/autoscale.py``).

``python -m opsagent_tpu_torch snapshot create --out DIR --model-name
bench-8b`` builds and warms an engine and writes its snapshot (weights in
the JAX package's leaf layout, the kernel libraries, the KV plan; with
``--tp``/``--sp``/``--ep`` and ``--nproc N`` at a mesh, every rank gathering
its shards and rank 0 writing whole leaves, which ``serve-engine
--restore-snapshot DIR --nproc N`` restores);
``snapshot verify DIR [--quick]`` checks one (the port's or the JAX
package's): exit 0 when it is whole, 1 when it is not, 2 when it cannot be
read.

The agent's commands (``server``, ``execute``, ``analyze``, ``audit``,
``diagnose``, ``generate``, ``version``, and ``--config FILE`` before them)
and the operator commands (``slo-check``, ``top``, ``perf-check``,
``timeline``, ``fleet-kv``, ``fleet-flight``, ``audit-fanout``) are
``cli/main.py``'s: ``python -m opsagent_tpu_torch execute --model
cuda://bench-8b "count the namespaces"``."""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

from . import obs
from .cli.main import COMMANDS as AGENT_COMMANDS
from .serving.api import ServingStack, make_server
from .serving.engine import Engine, EngineConfig


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    first = next((a for a in argv if not a.startswith("-")), "")
    if argv[:1] == ["--config"] or first in AGENT_COMMANDS:
        from .cli.main import main as agent_main

        return agent_main(argv)
    parser = argparse.ArgumentParser(prog="python -m opsagent_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    se = sub.add_parser(
        "serve-engine", help="serve OpenAI chat completions from the engine"
    )
    se.add_argument(
        "--model-name", default="tiny-test",
        help="model preset (e.g. bench-8b, qwen2.5-7b-instruct, "
             "deepseek-v2-lite), or 'auto' for --checkpoint's config.json",
    )
    se.add_argument(
        "--checkpoint", default="",
        help="HF safetensors checkpoint directory (default: random weights)",
    )
    se.add_argument(
        "--tokenizer", default="",
        help="directory of a byte-level-BPE tokenizer.json (default: the "
             "checkpoint's, else the byte tokenizer)",
    )
    se.add_argument("--host", default="0.0.0.0")
    se.add_argument("--port", type=int, default=8000)
    se.add_argument("--device", default=None, help="cuda (default) or cpu")
    se.add_argument("--seed", type=int, default=0, help="random-weight seed")
    se.add_argument(
        "--paged-backend", default="dma", choices=("dma", "grid"),
        help="paged-attention kernels: dma (one block walks a sequence's "
             "pages) or grid (split over the KV sequence); MLA models serve "
             "on dma",
    )
    se.add_argument(
        "--quantize", default="", choices=("", "int8", "int4"),
        help="weight-only quantization: int8 halves the weight bytes each "
             "step streams, int4 (group-wise scales) halves them again",
    )
    se.add_argument(
        "--kv-quantize", default="", choices=("", "int8"),
        help="KV-cache quantization: int8 pages + per-token scales, about "
             "half the KV bytes of bf16",
    )
    se.add_argument(
        "--speculative-k", type=int, default=0,
        help="prompt-lookup speculative decoding: draft k tokens a decode "
             "iteration from the sequence's own history and verify them in "
             "one forward (greedy blocks only, exact there); pays on "
             "repetitive outputs. 0 disables",
    )
    se.add_argument(
        "--async-depth", type=int, default=2,
        help="mixed ticks enqueued ahead of their commit: 2 (the default) "
             "enqueues tick t+1 before tick t's tokens are pulled; 1 serves "
             "each tick synchronously",
    )
    se.add_argument(
        "--profile-dir", default="",
        help="directory the profiling routes write torch.profiler traces "
             "and memory snapshots into (sets OPSAGENT_PROFILE_DIR; without "
             "it those routes answer 403)",
    )
    se.add_argument(
        "--offload", action="store_true",
        help="the host KV tier: evicted and parked pages kept in host RAM "
             "and restored by a copy instead of a re-prefill",
    )
    se.add_argument(
        "--host-pool-bytes", type=int, default=0,
        help="host pool byte bound (default: OPSAGENT_KV_HOST_POOL_BYTES, "
             "else 1 GiB)",
    )
    se.add_argument("--offload-copy-pages", type=int, default=8,
                    help="pages per host<->device copy")
    se.add_argument(
        "--restore-snapshot", default="",
        help="serve an engine restored from this snapshot directory, with "
             "its model and engine configuration (--device, --host-pool-bytes "
             "and --eager apply); a snapshot written at a mesh restores in a "
             "job of as many ranks (--nproc)",
    )
    se.add_argument(
        "--join-fleet", default="",
        help="fleet router base URL (serve-router): register this replica, "
             "heartbeat load + prefix digests, accept routed traffic and "
             "KV-page transfers",
    )
    se.add_argument("--advertise", default="",
                    help="URL the router reaches this replica at "
                         "(default: http://<host>:<port>)")
    se.add_argument("--replica-id", default="",
                    help="stable replica identity in the fleet (default: random)")
    se.add_argument("--tp", type=int, default=0,
                    help="tensor-parallel ranks (0 = every rank the other axes leave)")
    se.add_argument("--sp", type=int, default=1,
                    help="sequence-parallel ranks of a fresh prompt's prefill "
                         "attention (ring attention)")
    se.add_argument("--ep", type=int, default=1,
                    help="expert-parallel ranks for MoE models (experts shard over ep)")
    se.add_argument("--dist-backend", default="nccl", choices=("nccl", "gloo"),
                    help="process-group backend of a job of several ranks: nccl "
                         "between cards, gloo on the CPU or for ranks sharing a card")
    se.add_argument("--nproc", type=int, default=0,
                    help="spawn this many ranks on this host (torch's launch "
                         "variables set for each) and serve from rank 0")
    se.add_argument("--eager", action="store_true",
                    help="run the steps without CUDA graphs (required at tp, sp or "
                         "ep > 1)")
    se.add_argument(
        "--replica-role", default="decode", choices=("decode", "prefill", "standby"),
        help="decode replicas serve sessions end-to-end; prefill replicas take "
             "the router's long cold admissions and hand their KV to a decode "
             "replica; standby replicas are registered but unroutable until "
             "promoted to decode",
    )
    sr = sub.add_parser(
        "serve-router",
        help="run the fleet router: spreads sessions over the engine replicas "
             "that join it (prefix affinity, least load, sticky pinning, KV-page "
             "session migration, drain)",
    )
    sr.add_argument("--port", type=int, default=8090)
    sr.add_argument("--host", default="0.0.0.0")
    sr.add_argument(
        "--tokenizer", default="",
        help="tokenizer.json directory for affinity scoring; must match the "
             "replicas' (else scores are zero and placement is least-loaded); "
             "default: the byte tokenizer",
    )
    sr.add_argument("--model-name", default="",
                    help="model family for chat-template rendering in affinity "
                         "scoring (the replicas' --model-name)")
    sr.add_argument("--no-affinity", action="store_true", default=False,
                    help="disable prefix-affinity scoring (least-loaded only)")
    sr.add_argument("--queue-spill", type=int, default=None,
                    help="queue depth past which a pinned/affinity replica spills "
                         "the route to the rest of the fleet (default: the "
                         "replica's registered capacity)")
    sr.add_argument("--prefill-threshold", type=int, default=256,
                    help="prompt tokens at which a cold admission goes to a "
                         "role=prefill replica first (when one is registered)")
    sr.add_argument("--heartbeat-ttl", type=float, default=None,
                    help="seconds without a heartbeat before a replica is reaped "
                         "(default 10, or OPSAGENT_FLEET_HEARTBEAT_TTL_S)")
    sr.add_argument("--max-retries", type=int, default=2,
                    help="connect-phase re-routes per request before the error "
                         "reaches the client")
    sr.add_argument("--hedge-queue-depth", type=int, default=None,
                    help="TTFT hedging: race a duplicate of a queued cold "
                         "non-streaming admission on a second replica once the "
                         "chosen replica's queue is this deep (default: off)")
    sr.add_argument("--shed-queue-depth", type=int, default=None,
                    help="overload shedding: 429 + Retry-After for new admissions "
                         "once every replica's queue is this deep (default: off)")
    sr.add_argument("--autoscale-snapshot", default="",
                    help="elastic scale-out: launch standby replicas from this "
                         "`snapshot create` directory when shed pressure appears, "
                         "promote them once request-ready (default: off; pair with "
                         "--shed-queue-depth, the scale-up signal)")
    sr.add_argument("--autoscale-max-replicas", type=int, default=4,
                    help="upper bound on autoscaler-launched replicas")
    sr.add_argument("--autoscale-port-base", type=int, default=8400,
                    help="first port for autoscaler-launched engine servers "
                         "(sequential from here)")
    sr.add_argument("--autoscale-cooldown", type=float, default=30.0,
                    help="seconds between autoscaler launches")
    sn = sub.add_parser("snapshot", help="engine snapshots: create, verify")
    snsub = sn.add_subparsers(dest="snapshot_cmd", required=True)
    snc = snsub.add_parser(
        "create", help="build and warm an engine, then write its snapshot")
    snc.add_argument("--out", required=True, help="snapshot directory")
    snc.add_argument("--model-name", default="tiny-test")
    snc.add_argument("--checkpoint", default="")
    snc.add_argument("--tokenizer", default="")
    snc.add_argument("--device", default=None, help="cuda (default) or cpu")
    snc.add_argument("--seed", type=int, default=0)
    snc.add_argument("--max-batch-size", type=int, default=8)
    snc.add_argument("--paged-backend", default="dma", choices=("dma", "grid"))
    snc.add_argument("--quantize", default="", choices=("", "int8", "int4"))
    snc.add_argument("--kv-quantize", default="", choices=("", "int8"))
    snc.add_argument("--speculative-k", type=int, default=0)
    snc.add_argument("--offload", action="store_true")
    snc.add_argument("--async-depth", type=int, default=2)
    snc.add_argument("--tp", type=int, default=0,
                     help="tensor-parallel ranks (0 = every rank the other axes leave)")
    snc.add_argument("--sp", type=int, default=1)
    snc.add_argument("--ep", type=int, default=1)
    snc.add_argument("--dist-backend", default="nccl", choices=("nccl", "gloo"))
    snc.add_argument("--nproc", type=int, default=0,
                     help="spawn this many ranks on this host and write the "
                          "snapshot from rank 0, every rank gathering its shards")
    snc.add_argument("--eager", action="store_true",
                     help="run the steps without CUDA graphs (required over gloo at "
                          "tp, sp or ep > 1)")
    snv = snsub.add_parser(
        "verify", help="check a snapshot's manifest, fingerprint and weight "
                       "leaves (exit 0 ok / 1 failed / 2 unreadable)")
    snv.add_argument("path", help="snapshot directory")
    snv.add_argument("--quick", action="store_true",
                     help="sizes only, no per-leaf content digests")
    args = parser.parse_args(argv)
    args.argv = argv

    logging.basicConfig(level=logging.INFO)
    if args.command == "snapshot":
        return _snapshot(args)
    if args.command == "serve-router":
        from .serving.fleet.router import run_router_server

        run_router_server(
            host=args.host, port=args.port, tokenizer=args.tokenizer,
            model_name=args.model_name, affinity=not args.no_affinity,
            queue_spill=args.queue_spill, prefill_threshold=args.prefill_threshold,
            heartbeat_ttl_s=args.heartbeat_ttl, max_retries=args.max_retries,
            hedge_queue_depth=args.hedge_queue_depth,
            shed_queue_depth=args.shed_queue_depth,
            autoscale_snapshot=args.autoscale_snapshot,
            autoscale_max_replicas=args.autoscale_max_replicas,
            autoscale_port_base=args.autoscale_port_base,
            autoscale_cooldown_s=args.autoscale_cooldown,
        )
        return 0
    return _serve(args)


def _spawned(args: argparse.Namespace) -> int | None:
    """With ``--nproc`` > 1: run this command line (without it) as that many
    ranks of one host, and return the job's exit code; else None."""
    if args.nproc <= 1:
        return None
    from .serving.spmd import spawn_ranks

    argv = args.argv
    cut = argv.index("--nproc") if "--nproc" in argv else None
    rest = (argv[:cut] + argv[cut + 2:] if cut is not None
            else [a for a in argv if not a.startswith("--nproc=")])
    return spawn_ranks(args.nproc, ["-m", "opsagent_tpu_torch", *rest])


def _snapshot(args: argparse.Namespace) -> int:
    if args.snapshot_cmd == "verify":
        from .serving.snapshot.manifest import SnapshotError, verify_snapshot

        try:
            report = verify_snapshot(args.path, quick=args.quick)
        except SnapshotError as e:
            print(f"snapshot unreadable: {e}", file=sys.stderr)
            return 2
        print(json.dumps(report, indent=2))
        return 0 if report["ok"] else 1
    spawned = _spawned(args)
    if spawned is not None:
        return spawned
    from .parallel.mesh import rank_job

    return rank_job(args.dist_backend, _create_snapshot, args)


def _create_snapshot(args: argparse.Namespace) -> int:
    """This rank's part of ``snapshot create``."""
    tokenizer = args.tokenizer
    if not tokenizer and args.checkpoint and os.path.exists(
            os.path.join(args.checkpoint, "tokenizer.json")):
        tokenizer = args.checkpoint
    engine = Engine(EngineConfig(
        model=args.model_name, checkpoint=args.checkpoint, tokenizer=tokenizer,
        device=args.device, seed=args.seed, max_batch_size=args.max_batch_size,
        paged_backend=args.paged_backend, quantize=args.quantize,
        kv_quantize=args.kv_quantize, offload=args.offload,
        async_depth=args.async_depth, speculative_k=args.speculative_k,
        tp=args.tp, sp=args.sp, ep=args.ep, cuda_graphs=not args.eager,
    ))
    if not engine.mesh.leader:
        # A follower gathers its shards for the leader's warmup and writes.
        engine.follow()
        return 0
    try:
        # Warm first: the kernel libraries the snapshot carries are built.
        engine.warmup()
        man = engine.snapshot(args.out)
    finally:
        engine.stop_followers()
    print(json.dumps({
        "path": os.path.abspath(args.out), "fingerprint": man["fingerprint"],
        "leaves": len(man["leaves"]),
        "compile_cache_entries": man["compile_cache"]["entries"],
    }, indent=2))
    return 0


def _serve(args: argparse.Namespace) -> int:
    spawned = _spawned(args)
    if spawned is not None:
        return spawned
    from .parallel.mesh import rank_job

    return rank_job(args.dist_backend, _serve_rank, args)


def _serve_rank(args: argparse.Namespace) -> int:
    """This rank's part of ``serve-engine``: the leader serves, a follower
    runs its steps."""
    if args.profile_dir:
        os.environ["OPSAGENT_PROFILE_DIR"] = args.profile_dir
    tokenizer = args.tokenizer
    if not tokenizer and args.checkpoint and os.path.exists(
            os.path.join(args.checkpoint, "tokenizer.json")):
        tokenizer = args.checkpoint
    if args.restore_snapshot:
        # The snapshot's configuration holds (the host tier is on when it
        # was created with --offload); the pool's bound is the caller's.
        engine = Engine.from_snapshot(args.restore_snapshot, device=args.device,
                                      host_pool_bytes=args.host_pool_bytes,
                                      eager=args.eager)
    else:
        engine = Engine(EngineConfig(
            model=args.model_name, checkpoint=args.checkpoint, tokenizer=tokenizer,
            device=args.device,
            seed=args.seed, quantize=args.quantize, kv_quantize=args.kv_quantize,
            paged_backend=args.paged_backend, async_depth=args.async_depth,
            offload=args.offload, host_pool_bytes=args.host_pool_bytes,
            offload_copy_pages=args.offload_copy_pages, speculative_k=args.speculative_k,
            tp=args.tp, sp=args.sp, ep=args.ep, cuda_graphs=not args.eager,
        ))
    if not engine.mesh.leader:
        # A follower runs the leader's steps on its shards until it stops.
        engine.follow()
        return 0
    try:
        return _lead(args, engine)
    finally:
        engine.stop_followers()


def _lead(args: argparse.Namespace, engine: Engine) -> int:
    """Rank 0 (or the only rank): warm up, serve, join the fleet."""
    # Kernels built and the steps captured before the scheduler thread and
    # the HTTP server start: a capture is process-wide.
    warm = engine.warmup()
    stack = ServingStack(engine)
    membership = None
    if args.join_fleet:
        from .serving.fleet.client import FleetMembership

        membership = FleetMembership(
            stack, router_url=args.join_fleet,
            advertise_url=args.advertise or f"http://{args.host}:{args.port}",
            replica_id=args.replica_id, role=args.replica_role,
        )
        if engine.offload is not None:
            # Fleet-global KV: admission misses ask the router's page
            # directory and fetch chains from the owning peer.
            from .serving.fleet.pagestore import http_client

            engine.pagestore = http_client(args.join_fleet, membership.replica_id, engine)
    server = make_server(stack, args.host, args.port, membership=membership)
    # Continuous SLO evaluation (GET /api/slo serves the same watchdog) and
    # the telemetry history's 1 Hz sampler.
    watchdog, history = obs.slo.get_watchdog(), obs.history.get_history()
    watchdog.start()
    history.start()
    host, port = server.server_address[:2]
    print(f"serving {engine.model_cfg.name} on http://{host}:{port} "
          f"({engine.impl_info()}; warmed up in {warm:.1f} s)", flush=True)
    if membership is not None:
        # Joined after the socket is bound: the router may reach the
        # advertised URL the moment the registration lands.
        membership.start()
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if membership is not None:
            membership.stop()
        server.server_close()
        history.stop()
        watchdog.stop()
        stack.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
