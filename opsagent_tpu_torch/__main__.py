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
restored from a snapshot.

``python -m opsagent_tpu_torch snapshot create --out DIR --model-name
bench-8b`` builds and warms an engine and writes its snapshot (weights in
the JAX package's leaf layout, the kernel libraries, the KV plan);
``snapshot verify DIR [--quick]`` checks one (the port's or the JAX
package's): exit 0 when it is whole, 1 when it is not, 2 when it cannot be
read.

The agent's commands (``server``, ``execute``, ``analyze``, ``audit``,
``diagnose``, ``generate``, ``version``, and ``--config FILE`` before them)
are ``cli/main.py``'s: ``python -m opsagent_tpu_torch execute --model
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
             "its model and engine configuration (--device and "
             "--host-pool-bytes apply)",
    )
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
    snc.add_argument("--offload", action="store_true")
    snc.add_argument("--async-depth", type=int, default=2)
    snv = snsub.add_parser(
        "verify", help="check a snapshot's manifest, fingerprint and weight "
                       "leaves (exit 0 ok / 1 failed / 2 unreadable)")
    snv.add_argument("path", help="snapshot directory")
    snv.add_argument("--quick", action="store_true",
                     help="sizes only, no per-leaf content digests")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    if args.command == "snapshot":
        return _snapshot(args)
    return _serve(args)


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
    tokenizer = args.tokenizer
    if not tokenizer and args.checkpoint and os.path.exists(
            os.path.join(args.checkpoint, "tokenizer.json")):
        tokenizer = args.checkpoint
    engine = Engine(EngineConfig(
        model=args.model_name, checkpoint=args.checkpoint, tokenizer=tokenizer,
        device=args.device, seed=args.seed, max_batch_size=args.max_batch_size,
        paged_backend=args.paged_backend, quantize=args.quantize,
        kv_quantize=args.kv_quantize, offload=args.offload,
        async_depth=args.async_depth,
    ))
    # Warm first: the kernel libraries the snapshot carries are built.
    engine.warmup()
    man = engine.snapshot(args.out)
    print(json.dumps({
        "path": os.path.abspath(args.out), "fingerprint": man["fingerprint"],
        "leaves": len(man["leaves"]),
        "compile_cache_entries": man["compile_cache"]["entries"],
    }, indent=2))
    return 0


def _serve(args: argparse.Namespace) -> int:
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
                                      host_pool_bytes=args.host_pool_bytes)
    else:
        engine = Engine(EngineConfig(
            model=args.model_name, checkpoint=args.checkpoint, tokenizer=tokenizer,
            device=args.device,
            seed=args.seed, quantize=args.quantize, kv_quantize=args.kv_quantize,
            paged_backend=args.paged_backend, async_depth=args.async_depth,
            offload=args.offload, host_pool_bytes=args.host_pool_bytes,
            offload_copy_pages=args.offload_copy_pages,
        ))
    # Kernels built and the steps captured before the scheduler thread and
    # the HTTP server start: a capture is process-wide.
    warm = engine.warmup()
    stack = ServingStack(engine)
    server = make_server(stack, args.host, args.port)
    # Continuous SLO evaluation (GET /api/slo serves the same watchdog) and
    # the telemetry history's 1 Hz sampler.
    watchdog, history = obs.slo.get_watchdog(), obs.history.get_history()
    watchdog.start()
    history.start()
    host, port = server.server_address[:2]
    print(f"serving {engine.model_cfg.name} on http://{host}:{port} "
          f"({engine.impl_info()}; warmed up in {warm:.1f} s)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        history.stop()
        watchdog.stop()
        stack.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
