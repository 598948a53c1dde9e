"""Serving steps as device programs: CUDA graphs of the block decode's step
body and of the mixed tick's forward + sample, each captured once and
replayed (the port's counterpart of the JAX package's serving programs:
``decode_block``, one XLA program per dispatch,
``opsagent_tpu/serving/decode_loop.py``, and one prefill program per
bucket, compiled by ``Engine.warmup``).

Eagerly, a step dispatches the whole model from Python: every layer's
norms, projections, rope, cache writes and attention, and with quantized
weights 7 x layers + 1 matmul calls through ctypes. A replay launches the
same kernels on the same buffers with one call, so a step's host time no
longer grows with the model.

What a capture needs, and where it comes from:

- static buffers: a step body reads and writes only its state
  (``DecodeState``, ``MixedState``), the constraint tables (``FsmTables``),
  the cache's backing tensors and the weights, and the caller copies each
  step's inputs into them. None may be rebound or reallocated after
  capture (the graph holds their addresses); ``replay`` raises if a state,
  table or cache buffer was;
- no host sync and no allocation the next step reads: ``Llama`` sends
  dropped rows to the cache's scratch slot, the attention kernels plan
  their splits from shapes alone, and every kernel launches on the current
  stream;
- everything done once per kernel instance before the capture: the
  shared-memory opt-in of each attention and matmul instance and the
  split calls' workspaces (``Engine.warmup`` runs each body eagerly
  first);
- the sampler's generator registered with the graph, so that each replay
  draws fresh numbers from the generator's current offset and advances it,
  as an eager step does.

At a mesh over NCCL (a card a rank) a step's collectives are captured with
it: each all-reduce and all-gather becomes a node of the graph, and a
replay runs them over the same communicators, as JAX compiles a step at
a mesh into one program. Every rank captures the same bodies in the same
order (``Engine.warmup`` runs as one lockstep op), after eager runs of
each body that have put every communicator to use, and the capture runs
in thread-local mode: NCCL's watchdog thread polls its events meanwhile.
gloo's collectives run on the host and cannot be captured.

A capture is the port's counterpart of an XLA compile: its wall time goes
to the compile watchdog (``obs.flight.on_compile``), so a capture after a
completed ``Engine.warmup`` shows as ``opsagent_post_warmup_compiles`` and
a flight anomaly.

The launch counters (``ops.paged_attention.LAUNCHES``,
``ops.quant_matmul.LAUNCHES`` and ``INSTANCE_LAUNCHES``) count Python
calls; a capture runs no kernel, so its counts are taken back and added
again on every replay: a counter keeps meaning kernels run.
"""

from __future__ import annotations

import gc
import time
from typing import Callable

import torch

from .. import obs
from ..models.llama import PagedKVCache
from ..ops import paged_attention, quant_matmul
from .decode_loop import StaticBuffers

COUNTERS = (paged_attention.LAUNCHES, quant_matmul.LAUNCHES, quant_matmul.INSTANCE_LAUNCHES)


class StepGraph:
    """``body`` (one step over the static ``buffers`` and ``cache``)
    captured as a CUDA graph on the current device, with ``generator`` (the
    one the body samples from, if any) registered. ``collectives``: the
    body holds NCCL collectives (a step at a mesh), captured in
    thread-local mode. A failed capture raises from the constructor; there
    is no fallback."""

    def __init__(
        self, body: Callable[[], None], buffers: tuple[StaticBuffers, ...],
        cache: PagedKVCache, generator: torch.Generator | None = None,
        collectives: bool = False,
    ):
        self._buffers, self._cache = buffers, cache
        self._pointers = self._addresses()
        t0 = time.perf_counter()
        before = [dict(counts) for counts in COUNTERS]
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            self.graph.register_generator_state(generator)
        # No garbage collection while the capture runs (``torch.cuda.graph``
        # collects once as it starts): a collected graph of an older engine
        # resets itself, and any CUDA call on any thread during a capture
        # invalidates it.
        collecting = gc.isenabled()
        gc.disable()
        try:
            mode = {"capture_error_mode": "thread_local"} if collectives else {}
            with torch.cuda.graph(self.graph, **mode):
                body()
        finally:
            if collecting:
                gc.enable()
        self._launches = []
        for counts, was in zip(COUNTERS, before):
            delta = {k: n - was[k] for k, n in counts.items() if n != was[k]}
            for k, n in delta.items():
                counts[k] -= n
            self._launches.append((counts, delta))
        obs.flight.on_compile(time.perf_counter() - t0, what="cuda_graph")

    def _addresses(self) -> list[int]:
        tensors = [t for b in self._buffers for t in b.buffers()]
        return [t.data_ptr() for t in (*tensors, *self._cache.buffers())]

    def replay(self) -> None:
        """One step: the captured kernels over the buffers as they stand.
        Raises if a buffer the capture read was rebound since."""
        if self._addresses() != self._pointers:
            raise RuntimeError(
                "a buffer of a captured step moved after capture; the graph "
                "would read and write the old one"
            )
        self.graph.replay()
        for counts, delta in self._launches:
            for k, n in delta.items():
                counts[k] += n
