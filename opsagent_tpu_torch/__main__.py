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
(``/api/debug/profile``, ``/api/debug/memory``, ``/v1/profile/*``)."""

from __future__ import annotations

import argparse
import logging
import os
import sys

from . import obs
from .serving.api import ServingStack, make_server
from .serving.engine import Engine, EngineConfig


def main(argv: list[str] | None = None) -> int:
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
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    if args.profile_dir:
        os.environ["OPSAGENT_PROFILE_DIR"] = args.profile_dir
    tokenizer = args.tokenizer
    if not tokenizer and args.checkpoint and os.path.exists(
            os.path.join(args.checkpoint, "tokenizer.json")):
        tokenizer = args.checkpoint
    engine = Engine(EngineConfig(
        model=args.model_name, checkpoint=args.checkpoint, tokenizer=tokenizer,
        device=args.device,
        seed=args.seed, quantize=args.quantize, kv_quantize=args.kv_quantize,
        paged_backend=args.paged_backend, async_depth=args.async_depth,
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
