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

The launch counters (``ops.paged_attention.LAUNCHES``,
``ops.quant_matmul.LAUNCHES`` and ``INSTANCE_LAUNCHES``) count Python
calls; a capture runs no kernel, so its counts are taken back and added
again on every replay: a counter keeps meaning kernels run.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..models.llama import PagedKVCache
from ..ops import paged_attention, quant_matmul
from .decode_loop import StaticBuffers

COUNTERS = (paged_attention.LAUNCHES, quant_matmul.LAUNCHES, quant_matmul.INSTANCE_LAUNCHES)


class StepGraph:
    """``body`` (one step over the static ``buffers`` and ``cache``)
    captured as a CUDA graph on the current device, with ``generator`` (the
    one the body samples from, if any) registered. A failed capture raises
    from the constructor; there is no fallback."""

    def __init__(
        self, body: Callable[[], None], buffers: tuple[StaticBuffers, ...],
        cache: PagedKVCache, generator: torch.Generator | None = None,
    ):
        self._buffers, self._cache = buffers, cache
        self._pointers = self._addresses()
        before = [dict(counts) for counts in COUNTERS]
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            self.graph.register_generator_state(generator)
        with torch.cuda.graph(self.graph):
            body()
        self._launches = []
        for counts, was in zip(COUNTERS, before):
            delta = {k: n - was[k] for k, n in counts.items() if n != was[k]}
            for k, n in delta.items():
                counts[k] -= n
            self._launches.append((counts, delta))

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
