"""``python -m opsagent_tpu_torch audit-fanout``: run one cluster-scale audit
fan-out (the port's counterpart of ``opsagent_tpu/cli/fanout.py``).

Builds an in-process fleet (N replicas of one engine configuration behind a
``FleetRouter``, each with the host KV tier on), generates the seeded
synthetic cluster, and runs the plan / scatter / reduce pipeline over it.

Prints the deterministic report to stdout (``--json`` for the canonical byte
form) and the run's serving-side stats to stderr. Exit 0 when every child
audited ok, 1 when any child degraded to a ``finding_unavailable`` row.
"""

from __future__ import annotations

import json
import sys


def run_audit_fanout(
    model: str = "tiny-test",
    resources: int = 64,
    seed: int = 0,
    issue_fraction: float = 0.25,
    replicas: int = 2,
    max_inflight: int = 8,
    max_tokens: int = 16,
    flight_sample: int = 0,
    as_json: bool = False,
    out: str = "",
    device: str | None = None,
) -> int:
    """The command's body: the engines serve on ``device`` (``cuda`` unless
    ``cpu`` is asked for), in bf16 on the card and f32 on the CPU, as the
    JAX command serves bf16 on the TPU and f32 elsewhere."""
    import torch

    from ..agent.fanout import FanoutConfig, SynthCluster, run_audit
    from ..device import resolve_device
    from ..serving.api import ServingStack
    from ..serving.engine import Engine, EngineConfig
    from ..serving.fleet.router import FleetRouter

    dev = resolve_device(device)
    cfg = EngineConfig(
        model=model,
        dtype=torch.bfloat16 if dev.type == "cuda" else torch.float32,
        device=str(dev),
        max_batch_size=8,
        page_size=16,
        num_pages=2048,
        max_pages_per_seq=64,
        prefill_buckets=(64, 128, 256),
        decode_block=8,
        offload=True,
    )
    router = FleetRouter(sticky=False)
    engines = [Engine(cfg) for _ in range(max(1, replicas))]
    # Every capture before any scheduler thread runs: a capture is
    # process-wide.
    for engine in engines:
        engine.warmup()
    stacks = []
    try:
        for i, engine in enumerate(engines):
            stacks.append(ServingStack(engine))
            router.add_local(stacks[-1], f"fanout-r{i}")
        cluster = SynthCluster(resources=resources, seed=seed, issue_fraction=issue_fraction)
        rep = run_audit(router, cluster, FanoutConfig(
            max_inflight=max_inflight, max_tokens=max_tokens, flight_sample=flight_sample,
        ))
    finally:
        for stack in stacks:
            stack.close()
    if out:
        with open(out, "w") as f:
            f.write(rep.canonical + "\n")
    if as_json:
        print(rep.canonical)
    else:
        print(json.dumps(rep.report, indent=2))
    stats = dict(rep.stats)
    stats["recall"] = rep.recall(cluster)
    print(json.dumps({"fanout_stats": stats}), file=sys.stderr)
    return 0 if stats["outcomes"].get("ok", 0) == resources else 1
