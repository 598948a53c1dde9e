"""The lockstep step channel: one engine served by several ranks.

The JAX engine is a single controller: one process dispatches each step
over every device of its mesh. The port runs one process per rank
(``parallel.mesh``), each holding its shard of the model and of the KV
cache, so the ranks must run the same device steps in the same order:

- **The leader**, global rank 0, runs everything a one-rank engine runs:
  the scheduler, the HTTP front end, the page allocator and every host
  decision. Each device step goes through one choke point,
  ``Engine._device(op, *args)``: before running it, the leader publishes
  the step's record (its name and its host inputs: token ids, positions,
  page tables, lengths, budgets, sampler inputs, FSM rows, the loads of
  the step state) on the mesh's gloo group for host metadata.
- **The followers** run ``Engine.follow()``: receive a record, run the
  same op on their shards, repeat, until a ``stop`` record arrives
  (``Engine.stop_followers``). Every rank holds the same full logits after
  the head's all-gather and draws from generators seeded alike, so every
  rank samples the same tokens; ``Engine.spmd_outputs`` keeps each op's
  outputs on every rank when set to a list, for the checks that they are.

A rank that fails mid-step leaves the others' collectives to raise: each
mesh group carries ``GROUP_TIMEOUT_S``, and a peer's exit closes its
connections. The channel's own group waits as long as the leader idles
(``IDLE_TIMEOUT_S``): an idle engine publishes nothing.

``spawn_ranks`` starts the N ranks of a one-host job under torch's launch
variables (the CLI's ``serve-engine --nproc N``).
"""

from __future__ import annotations

import logging
import os
import signal
import socket
import subprocess
import sys
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.mesh import Mesh

log = logging.getLogger("opsagent_tpu_torch.spmd")

STOP = "stop"


class StepChannel:
    """Step records from the leader to the followers, over the mesh's
    host-metadata group (``Mesh.meta_group``, gloo): a broadcast of each
    pickled ``(op, args)`` from global rank 0."""

    def __init__(self, mesh: Mesh):
        if mesh.meta_group is None:
            raise ValueError("a step channel needs a mesh of several ranks")
        self.group = mesh.meta_group
        self.leader = mesh.leader

    def publish(self, op: str, args: tuple) -> None:
        if not self.leader:
            raise RuntimeError("only the leader publishes steps")
        dist.broadcast_object_list([(op, args)], src=0, group=self.group)

    def receive(self) -> tuple[str, tuple]:
        box: list[Any] = [None]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]


def kept(out: Any) -> tuple[torch.Tensor, ...]:
    """An op's output tensors, copied on their device in stream order (no
    host sync: a later op may overwrite the buffers they came from): what
    ``Engine.spmd_outputs`` records."""
    if isinstance(out, torch.Tensor):
        return (out.detach().clone(),)
    if isinstance(out, (tuple, list)):
        return tuple(t for o in out for t in kept(o))
    return ()


def on_host(outputs: list) -> list[tuple[str, list[np.ndarray]]]:
    """``Engine.spmd_outputs`` as numpy arrays, op by op."""
    return [(op, [t.cpu().numpy() for t in ts]) for op, ts in outputs]


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(nproc: int, argv: list[str], env: dict[str, str] | None = None,
                poll_s: float = 0.5) -> int:
    """Run ``python argv`` as ``nproc`` ranks of one host under torch's
    launch variables (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK``). When a rank exits non-zero the others are
    terminated. Returns the first non-zero exit code, else 0."""
    base = dict(os.environ if env is None else env)
    base.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                WORLD_SIZE=str(nproc))
    procs = [subprocess.Popen([sys.executable, *argv],
                              env={**base, "RANK": str(r), "LOCAL_RANK": str(r)})
             for r in range(nproc)]

    def stop(signum, frame):
        raise SystemExit(128 + signum)

    # A terminated launcher stops its ranks (the finally below).
    signal.signal(signal.SIGTERM, stop)
    rc = 0
    try:
        while any(p.poll() is None for p in procs):
            failed = [p.returncode for p in procs if p.returncode not in (None, 0)]
            if failed:
                rc = failed[0]
                log.error("a rank exited with %d: stopping the others", rc)
                break
            time.sleep(poll_s)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    return rc or next((p.returncode for p in procs if p.returncode), 0)
