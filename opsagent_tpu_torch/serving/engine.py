"""Single-process serving engine over the paged KV cache (the port's
counterpart of ``opsagent_tpu/serving/engine.py``).

Two device programs carry the traffic:

- the mixed tick: one forward over decode lanes (one token each) and
  prefill chunks together, through the ragged paged-attention kernel;
- the block: up to ``decode_block`` decode + sample steps with the loop
  state on the device and one host pull, through the decode kernel.

On the card with the kernels each decode step and each mixed tick is one
CUDA graph replay (``serving.decode_graph``), captured by ``warmup``.

The JAX engine's default loop runs them ahead of the host:

- ``step_mixed_async`` (``EngineConfig.async_depth`` 2,
  ``serving.async_runtime``): tick t+1 is enqueued before tick t's tokens
  are pulled; decode lanes read their input token from the previous
  tick's output on the card. ``step_mixed`` is the synchronous tick.
- ``step_block`` with ``pipeline_depth`` 2: blocks k+1..k+depth are
  enqueued before block k's tokens reach the host. Each row holds a lane
  whose last token, write offset, FSM row and EOS flag carry over on the
  card (``DecodeState.load``'s carry form); pages are booked ahead for the
  blocks in flight and rolled back after a finish the host sees late. A
  block with a hosted or extras row runs synchronously, the pipeline
  drained first.
- ``ffwd_step`` (``grammar_ffwd``): a constrained row whose FSM state
  forces a run of tokens appends the run in one forward through the mixed
  graph of the bucket that holds it, and samples only the token after it.

With ``EngineConfig.mixed_batching`` off (and on a tick the mixed lanes
pass over) admissions take the split prefill lane, JAX's prefill programs:
``prefill_batch`` runs one chunk of up to ``prefill_batch`` admitting
prompts, each up to the largest of ``prefill_buckets`` (4096) tokens,
through ``Llama.prefill_with_prefix`` and the backend's ragged kernel,
eagerly, and samples a finished prompt's first token as a mixed tick does.

Tokens reach the host through pinned memory and an event per tick or
block (``decode_loop.to_host``); nothing else waits for the card between
an enqueue and its commit. Every entry point settles the other lanes'
state before it touches the rows they hold.

Constrained decoding (``mask_fn``, ``serving.constrained``) runs inside
those graphs. A row whose ``JsonConstraint`` has dense tables within the
budget, and whose FSM is the one loaded, is a device-FSM row: its DFA
state indexes the device tables (``FsmTables``), which mask its logits and
advance its state every step with no host sync. One table set is resident
at a time; it reloads when no live row uses it. Any other constrained row
(a plain callable, a schema over the budget such as ``json_object`` at a
128k vocab, a second schema while another is loaded) is hosted: the host
computes its mask, and it advances one token per ``step_block`` call, in a
one-step block of its own, beside the full block of the other rows.

The OpenAI sampler extras (``logit_bias``, presence and frequency
penalties, logprobs) run on the device too (``SamplingExtras``), in a
second graph of each step body: a block or tick whose rows ask for none
of them replays the plain graph, one with such a row the extras graph.
The engine loads the static bias, the host's token counts and the
penalties of the rows that ask for them, and the body keeps counting on
the device; a row asking for logprobs reads them back with its tokens.
Such rows keep their full block.

``EngineConfig.quantize`` and ``kv_quantize`` select int8/int4 weights
(every projection through the quantized matmul kernel) and int8 KV pages
(the attention kernels' int8 instances); ``paged_backend`` picks the
paged-attention kernels ("dma" or "grid"); ``attn_impl`` picks kernels or
plain versions for all of them at once. As in the JAX engine, a MoE model
serves through the all-experts form (``grouped_dispatch_min_tokens`` set to
0), an MLA model through one backend (JAX's gather, here the dma kernels'
latent instances: a ``grid`` request is logged and served on ``dma``), and
MLA refuses ``kv_quantize``. ``checkpoint`` loads an HF
safetensors directory instead of random weights.

Observability (``obs``, the port's copy of ``opsagent_tpu/obs``) records
at the JAX engine's call sites, on the host, once per admission, mixed tick,
block call, token and finish: the token and dispatch counters, TTFT and
inter-token latency, occupancy gauges, the flight ring's events, the
request's trace spans (``prefill``, ``decode`` with a ``mixed_step`` or
``decode_block`` child per tick or block) and the roofline attribution of
every tick and block (``obs.attribution``, at the H100's peaks). Nothing
records inside a step body: where steps replay, a body's Python runs once,
at capture. Tokens come back a block at a time, so a block's inter-token
latencies are one gap and then near-zero ones, as in JAX's block decode.
``warmup`` runs inside ``obs.flight.warmup_phase``: a capture after it is a
post-warmup compile.

The host KV tier (``serving.offload``, ``EngineConfig.offload``, with the
prefix cache): a trie eviction spills the page to a bounded host-RAM pool;
``park_chain`` (a session blocked on a tool) and ``park_sequence`` (the
scheduler's pressure parking) free a session's pages after copying them
out; an admission restores pooled pages of its prompt with a page copy
instead of re-prefilling them. With a fleet page store
(``Engine.pagestore``, ``serving/fleet/pagestore.py``), an admission whose
prompt misses the trie and the pool first faults the chain in from a peer
replica into the pool (``fault_in_prefix``), before it takes the engine
lock. ``snapshot`` and ``from_snapshot``
(``serving.snapshot``) write and restore the weights in the JAX package's
leaf layout and the built kernel libraries, so that a restored engine runs
no ``nvcc``; warmup recaptures the graphs.

Speculative decoding (``EngineConfig.speculative_k`` > 0, JAX's
prompt-lookup speculation, off by default as there): a block whose rows
are all greedy, none constrained and none with the sampler extras runs
``decode_loop.speculative_step_body`` in place of the decode step, each
iteration drafting k tokens from the row's own history and verifying
them in one ``Llama.verify_step`` through the ragged kernel, so a weight
stream emits 1 to k + 1 tokens a row. It is captured and replayed like
the decode step, shares its loop state (a row's carry passes between
speculative and plain blocks on the card) and gives the same greedy
tokens. Any other block decodes as before.
"""

from __future__ import annotations

import functools
import itertools
import logging
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field, replace
from functools import partial
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from .. import obs
from ..device import resolve_device
from ..models.config import ModelConfig, resolve_model
from ..models.llama import Llama
from ..models.loader import load_checkpoint
from ..ops.paged_attention import PAGED_BACKENDS
from ..parallel.mesh import AXES, Mesh, make_mesh, rank_device
from ..parallel.ring import make_ring_attention
from . import faults, spmd
from ..utils.perf import get_perf_stats
from ..utils.profiling import annotate, device_timer
from .async_runtime import AsyncMixedRuntime
from .constrained import NATIVE_TABLE_BUDGET, JsonConstraint, TokenFSM, device_table_fsm
from .decode_graph import StepGraph
from .decode_loop import (
    DecodeState,
    FsmTables,
    MixedState,
    SamplingExtras,
    SpecState,
    decode_block,
    decode_step_body,
    from_host,
    mixed_step_body,
    pick_rows,
    record_dispatch,
    record_ffwd_append,
    record_mixed_dispatch,
    speculative_block,
    speculative_step_body,
    to_host,
)
from .kvcache import InvalidRequest, OutOfPages, PageAllocator
from .offload import HostPagePool, OffloadManager, PageCopyEngine, chain_key_hex
from .sampler import SamplingParams
from .tokenizer import Tokenizer, load_tokenizer

log = logging.getLogger("opsagent_tpu_torch.engine")

# A constrained-decoding mask: the generated tokens -> [vocab] bool allowed.
MaskFn = Callable[[list[int]], np.ndarray]


def _locked(fn):
    """Run an Engine method under the engine's lock: the scheduler thread
    steps the engine while HTTP threads read its gauges."""

    @functools.wraps(fn)
    def run(self, *args, **kwargs):
        with self.lock:
            return fn(self, *args, **kwargs)

    return run


def _merge_pulls(out: dict[int, list[int]], pulled: dict[int, list[int]]) -> None:
    """Fold pulled tokens into an accumulated result: several pulls may
    carry tokens of one sequence, which ``dict.update`` would drop."""
    for sid, toks in pulled.items():
        out.setdefault(sid, []).extend(toks)


@dataclass
class EngineConfig:
    # A preset name, or "auto" for the checkpoint's own config.json.
    model: str = "tiny-test"
    # HF safetensors directory; "" = random weights from ``seed``.
    checkpoint: str = ""
    # A directory holding a byte-level-BPE tokenizer.json; "" = the byte
    # tokenizer over the model's vocab.
    tokenizer: str = ""
    dtype: torch.dtype = torch.bfloat16
    page_size: int = 16
    num_pages: int = 2048
    max_pages_per_seq: int = 320   # 5120 tokens
    max_batch_size: int = 8
    # Decode steps per step_block call: one host pull per block.
    decode_block: int = 32
    # Blocks in flight beyond the one being pulled: blocks k+1..k+depth are
    # enqueued before block k's tokens reach the host. 0 = synchronous.
    pipeline_depth: int = 2
    # Query-axis buckets of the mixed step: a chunk pads to the smallest
    # bucket holding it; the largest caps a chunk.
    mixed_buckets: tuple[int, ...] = (16, 32, 64, 128)
    # Per-mixed-step token budget: decode lanes first, then prefill chunks.
    max_step_tokens: int = 256
    # Mixed prefill + decode ticks (JAX's mixed batching): the scheduler
    # seats admitting prompts' chunks in the decode lanes' tick. False
    # admits every prompt through the split prefill lane instead
    # (``prefill_batch``), as does a tick the mixed lanes pass over.
    mixed_batching: bool = True
    # The split lane: up to prefill_batch admitting prompts' next chunks in
    # one dispatch, rows padded to a power of two, the chunk padded to the
    # smallest of prefill_buckets holding it (the largest caps a chunk).
    prefill_batch: int = 4
    prefill_buckets: tuple[int, ...] = (64, 128, 256, 512, 1024, 2048, 4096)
    # Depth of the async mixed ticks (serving.async_runtime): at 2 tick t+1
    # is enqueued before tick t's tokens are pulled; EOS and stop strings
    # are then seen a tick late (one overshoot token discarded, its page
    # booking rolled back). 1 = the synchronous tick. Constrained rows ride
    # it only on the device tables; hosted, logprobs and bias rows take the
    # sync lanes.
    async_depth: int = 2
    # Grammar fast-forward: a constrained row whose FSM state admits one
    # token emits the whole forced run without a forward per token, as one
    # multi-token append through the mixed tick, sampling only the token
    # after it. Greedy output is the same with it off. Rows off the device
    # tables, with logprobs or with a bias decode normally.
    grammar_ffwd: bool = True
    prefix_cache: bool = True
    seed: int = 0
    device: str | None = None      # None = cuda; "cpu" only on request
    # Kernels: "cuda" (the hand-written kernels for paged attention and,
    # with quantized weights, every projection; the default on a GPU) or
    # "plain" (the plain PyTorch versions: the only choice on the CPU, and
    # the reference build on a GPU). "" resolves by device.
    attn_impl: str = ""
    # Weight-only quantization: "" (compute dtype), "int8" (per-output-
    # channel scales) or "int4" (group-wise scales), models.quant. Random
    # weights are built directly in quantized form on the device.
    quantize: str = ""
    # KV-cache quantization: "" (pages in the compute dtype) or "int8"
    # (int8 pages + one f32 scale per token and kv head,
    # ops.attention.QuantizedPages): D + 4 bytes per row against 2 * D.
    kv_quantize: str = ""
    # Paged-attention kernels: "dma" (one block per sequence walks its
    # pages, the counterparts of the JAX package's pallas-dma kernels) or
    # "grid" (split over the KV sequence, the counterparts of its pallas
    # grid kernels). Both have the same plain version, which attn_impl
    # "plain" runs whatever the backend.
    paged_backend: str = "dma"
    # On the card with the kernels: True captures the decode step (greedy
    # and sampled) and each mixed bucket's forward + sample, each with and
    # without the sampler extras, as CUDA graphs
    # (``warmup``, or the first step that needs them) and replays them;
    # False runs the same steps eagerly through the same kernels, the
    # reference a replay is checked against. The plain path and the CPU
    # always run them eagerly.
    cuda_graphs: bool = True
    # The host KV tier (serving.offload), with prefix_cache only: trie
    # evictions spill page content to a bounded host pool instead of
    # dropping it, parking (park_chain / park_sequence) frees a session's
    # HBM while it waits, and admission restores pooled pages with a copy
    # instead of re-prefilling them.
    offload: bool = False
    # Pages per copy (the copy engine's largest bucket): page-id vectors
    # pad to (1, offload_copy_pages).
    offload_copy_pages: int = 8
    # Host pool byte bound; 0 = $OPSAGENT_KV_HOST_POOL_BYTES or 1 GiB.
    host_pool_bytes: int = 0
    # Speculative decoding (prompt lookup): draft this many tokens an
    # iteration from the row's own history (the last earlier occurrence of
    # its trailing speculative_ngram tokens) and verify them in one forward,
    # 1 to k + 1 tokens a weight stream. Greedy blocks only, exact there;
    # 0 = off, the JAX engine's default (its lookups hit rarely on the
    # agent workload: speculation pays on repetitive continuations).
    speculative_k: int = 0
    speculative_ngram: int = 2
    # The device mesh (parallel.mesh), JAX's fields, counted in ranks of
    # the job (one process each, torch.distributed's world): tensor-
    # parallel ranks (0 = every rank the other axes leave; lowered until
    # the kv heads and the vocab divide), data-parallel ranks (replicas of
    # every step), sequence-parallel ranks of a fresh prompt's prefill
    # attention (ring attention; sp divides every prefill bucket), and
    # expert-parallel ranks of a MoE model's experts. Several ranks serve
    # in lockstep (serving.spmd): rank 0 leads, the others ``follow``.
    tp: int = 0
    dp: int = 1
    sp: int = 1
    ep: int = 1


@dataclass
class Sequence:
    """Host-side state of one in-flight generation."""

    seq_id: int
    prompt_len: int
    prompt_ids: list[int] = field(default_factory=list)
    tokens: list[int] = field(default_factory=list)   # generated tokens
    params: SamplingParams = field(default_factory=SamplingParams)
    mask_fn: MaskFn | None = None  # constrained decoding
    on_token: Callable[[int], None] | None = None   # each accepted token
    done: bool = False
    finish_reason: str = ""        # "stop" | "length" | "error"
    # Per generated token, when params.logprobs: {"logprob": float,
    # "top": [(token_id, logprob), ...][:params.top_logprobs]}.
    logprob_data: list[dict] = field(default_factory=list)
    # The static logit_bias row [V] (built on first use).
    static_bias: np.ndarray | None = None
    # {token_id: count} of the generated tokens, for the penalties.
    penalty_counts: dict[int, int] | None = None
    ttft_s: float = 0.0
    started_s: float = field(default_factory=time.perf_counter)
    # Observability (obs.trace): the request's span handle under which the
    # engine records its prefill and decode spans, the open decode span,
    # and the previous accepted token's time for the inter-token latency.
    # Untraced sequences pay one None check.
    trace: Any = None
    decode_span: Any = None
    last_tok_s: float = 0.0
    # The exception a raising ``on_token`` callback ended the row with.
    error: Exception | None = None


class Engine:
    def __init__(
        self,
        cfg: EngineConfig,
        model_cfg: ModelConfig | None = None,
        model: Llama | None = None,
        tokenizer: Tokenizer | None = None,
        state: dict[str, torch.Tensor] | None = None,
    ):
        """``model``: a ready ``Llama`` on the engine's device (tests and
        the reference engine share one); ``state``: a full (one-rank) state
        dict on the host, of which the model built on the device keeps this
        rank's slice (a snapshot's memory-mapped leaves); otherwise the
        weights of ``cfg.checkpoint`` or, without one, random weights from
        ``cfg.seed`` are built on the device. In a job of several ranks
        every rank builds its engine (its shard); rank 0 serves, the others
        ``follow``."""
        self.model_cfg = model_cfg or (
            model.cfg if model is not None
            else resolve_model(cfg.model, cfg.checkpoint)
        )
        self.mesh = self._make_mesh(cfg)
        self._check_mesh(cfg)
        # A rank of a job on the card serves on cuda:{LOCAL_RANK % cards}.
        self.device = resolve_device(rank_device(cfg.device))
        if self.model_cfg.moe is not None:
            # Serving pins the exact all-experts form, as the JAX engine
            # does: a request's output must not depend on the chunking.
            self.model_cfg = replace(
                self.model_cfg,
                moe=replace(self.model_cfg.moe, grouped_dispatch_min_tokens=0),
            )
        if cfg.paged_backend not in PAGED_BACKENDS:
            raise ValueError(
                f"paged_backend={cfg.paged_backend!r}: expected one of "
                f"{sorted(PAGED_BACKENDS)}"
            )
        if self.model_cfg.mla is not None:
            if cfg.kv_quantize:
                raise ValueError("kv_quantize is not supported for MLA models")
            if cfg.paged_backend != "dma":
                # The latent instances are the dma kernels' (the JAX engine
                # forces its gather backend for MLA the same way).
                log.info("mla model: forcing dma paged attention (was %s)",
                         cfg.paged_backend)
                cfg = replace(cfg, paged_backend="dma")
        self.cfg = cfg
        impl = cfg.attn_impl or ("plain" if self.device.type == "cpu" else "cuda")
        if impl not in ("cuda", "plain"):
            raise ValueError(f"attn_impl={impl!r}: expected 'cuda' or 'plain'")
        if impl == "cuda" and self.device.type != "cuda":
            raise ValueError("attn_impl='cuda' needs a CUDA device")
        self.attn_impl = impl
        self.lock = threading.RLock()
        # The weight stream the roofline prices: with the kernels, quantized
        # weights run every projection through the quantized matmul kernel,
        # whose cp.async ring overlaps the stream with compute (the JAX
        # package's "pallas-dma"); otherwise torch.matmul ("xla": bytes/bw).
        self.weight_stream_impl = (
            "pallas-dma" if cfg.quantize and impl == "cuda" else "xla"
        )
        self.attr = obs.attribution.Attribution.for_engine(
            self.model_cfg, cfg, weight_stream=self.weight_stream_impl
        )
        obs.attribution.set_current(self.attr)
        self._evictions_seen = 0   # delta-sync base for the obs counter
        # perf_counter when the last mixed tick's replay was enqueued (the
        # host-gap observable); None across block calls and idle waits.
        self._mixed_gap_stamp: float | None = None
        # Llama and PagedKVCache validate quantize and kv_quantize.
        if model is not None and model.quantize != cfg.quantize:
            raise ValueError(
                f"quantize={cfg.quantize!r} but the given model holds "
                f"{model.quantize or 'unquantized'!r} weights"
            )
        self.tokenizer = tokenizer or load_tokenizer(cfg.tokenizer, self.model_cfg.vocab_size)
        t_load = time.perf_counter()
        if model is not None and self.mesh.size > 1 and (
                model.mesh is None or model.mesh.shape != self.mesh.shape):
            raise ValueError(f"the given model is not sharded over the engine's mesh "
                             f"{self.mesh.shape}")
        with torch.inference_mode():
            self.model = model if model is not None else self._build_model(state)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        # /healthz "init": how this engine came up. warmup() adds its wall
        # time; a snapshot restore stamps its source, fingerprint and the
        # kernel libraries it pre-seeded.
        self.init_stats: dict[str, Any] = {
            "weights_load_s": round(time.perf_counter() - t_load, 3),
            "warmup_s": 0.0,
            "restore_source": "",
            "snapshot_fingerprint": "",
            "kernel_cache_preseeded": 0,
        }
        with torch.inference_mode():
            self.cache = self.model.make_cache(
                cfg.num_pages, cfg.page_size, cfg.kv_quantize
            )
            # The block decode's loop state (made under inference mode, as
            # the body's in-place updates need).
            self._decode = DecodeState.empty(
                cfg.max_batch_size, cfg.max_pages_per_seq, cfg.decode_block,
                self.device,
            )
            # One mixed tick's buffers per query-axis bucket.
            self._mixed = {
                S: MixedState.empty(
                    cfg.max_batch_size, S, cfg.max_pages_per_seq, self.device
                )
                for S in cfg.mixed_buckets
            }
            # The constraint tables. Where steps replay, one capacity
            # buffer of the budget's rows, made before any capture and
            # loaded by copy; where they run eagerly, sized to each FSM
            # loaded.
            V = self.model_cfg.vocab_size
            rows = NATIVE_TABLE_BUDGET // V if self._replays() else 1
            self._fsm = FsmTables.empty(cfg.max_batch_size, V, rows, self.device)
            self._extras = SamplingExtras.empty(
                cfg.max_batch_size, V, cfg.decode_block, self.tokenizer.vocab_size,
                self.device,
            )
        # Batch rows whose bias or penalties the last extras load set.
        self._extras_rows: set[int] = set()
        self._fsm_loaded: TokenFSM | None = None
        self._host_rows = False     # host_mask holds a hosted row's mask
        # ("decode", greedy, extras) and ("mixed", bucket, extras) -> graph,
        # made by warmup.
        self._graphs: dict[tuple[str, object], StepGraph] = {}
        self._warm = False
        # Decode steps and mixed ticks run by graph replay and eagerly.
        self.decode_replays = self.decode_eager_steps = 0
        self.mixed_replays = self.mixed_eager_ticks = 0
        # Decode steps of hosted rows (one per row per step_block call),
        # table sets loaded, and the host seconds the loads took.
        self.hosted_steps = self.fsm_loads = 0
        self.fsm_load_s = 0.0
        self.alloc = PageAllocator(
            cfg.num_pages, cfg.page_size, cfg.max_pages_per_seq,
            prefix_cache=cfg.prefix_cache,
        )
        # The host KV tier: spills ride every trie eviction, restores ride
        # admission (begin_request).
        self.offload: OffloadManager | None = None
        if cfg.offload and cfg.prefix_cache:
            self.offload = OffloadManager(
                HostPagePool(cfg.page_size, capacity_bytes=cfg.host_pool_bytes or None),
                PageCopyEngine(copy_pages=cfg.offload_copy_pages, mesh=self.mesh),
                cfg.page_size,
            )
            self.alloc.attach_host_pool(self.offload.pool)
            self.alloc.set_spill(self._spill_page)
        # The fleet-global KV fault-in client (serving/fleet/pagestore.py),
        # wired by a fleet router (in-process) or serve-engine --join-fleet;
        # None: admission looks at the trie and the host pool only.
        self.pagestore: Any = None
        # (page, chain) pairs of evictions whose spill waits for the end of
        # a park (one gather a bucket of pages); None outside one.
        self._spill_batch: list[tuple[int, list[int]]] | None = None
        self._digests_truncated = False
        self.sequences: dict[int, Sequence] = {}
        self._prefilling: dict[int, int] = {}   # seq_id -> prompt tokens done
        # Pipelined blocks: each lane's sequence (its carry lives in
        # DecodeState's row), the blocks in flight (oldest first), and the
        # tokens each sequence has booked in them.
        self._lanes: list[int | None] = [None] * cfg.max_batch_size
        self._lane_of: dict[int, int] = {}
        self._inflight: deque[tuple] = deque()
        self._inflight_steps: dict[int, int] = {}
        # The async mixed ticks, and the sequences counted ffwd-ineligible.
        self._async = AsyncMixedRuntime(self)
        self._ffwd_noted: set[int] = set()
        # Async ticks enqueued, fast-forward appends of their own (sync
        # lane), forced tokens appended (both lanes), blocks enqueued ahead
        # of a pull.
        self.async_ticks = self.ffwd_dispatches = self.ffwd_tokens = 0
        self.pipelined_blocks = 0
        # Split-lane chunk dispatches (``prefill_batch``).
        self.prefill_dispatches = 0
        # Speculative blocks: iterations sized so that a block whose every
        # draft is accepted emits decode_block tokens (JAX's _spec_steps);
        # the drafting history is a row's tokens by position over the whole
        # window. Blocks run, and iterations replayed and run eagerly.
        self._spec_steps = max(1, cfg.decode_block // (cfg.speculative_k + 1))
        self._spec: SpecState | None = None
        if cfg.speculative_k > 0:
            with torch.inference_mode():
                self._spec = SpecState.empty(
                    cfg.max_batch_size, cfg.max_pages_per_seq * cfg.page_size,
                    self._spec_steps, cfg.speculative_k, self.device,
                )
        self.spec_blocks = self.spec_replays = self.spec_eager_steps = 0
        self._generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 1
        )
        # The split lane samples eagerly, outside the graphs that replay
        # with the engine's generator registered: a generator of its own.
        self._prefill_generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 2
        )
        # sp > 1: a fresh prompt's split-lane chunk attends by ring attention
        # over sp (JAX's prefill_attn); the mixed ticks, decode and prefix
        # chunks stay on the paged kernels.
        self._prefill_attn = (make_ring_attention(self.mesh)
                              if self.mesh.shape[AXES.sp] > 1 else None)
        # Lockstep (serving.spmd): the leader publishes every device step to
        # the followers. ``spmd_outputs`` (a list, when set) records each
        # op's outputs on this rank.
        self._channel = spmd.StepChannel(self.mesh) if self.mesh.size > 1 else None
        self._stopped = False
        self.spmd_outputs: list | None = None

    def _make_mesh(self, cfg: EngineConfig) -> Mesh:
        """The engine's mesh: the JAX engine's validation and its fall-back
        that lowers tp until the kv heads and the vocab divide, counting
        the job's ranks where JAX counts devices."""
        n = dist.get_world_size() if dist.is_initialized() else 1
        slots = cfg.dp * cfg.sp * cfg.ep
        if cfg.sp > 1:
            bad = [b for b in cfg.prefill_buckets if b % cfg.sp]
            if bad:
                raise ValueError(
                    f"sp={cfg.sp} must divide every prefill bucket "
                    f"(offending: {bad})"
                )
            if slots * max(1, cfg.tp) > n:
                raise ValueError(
                    f"dp={cfg.dp} * sp={cfg.sp} * ep={cfg.ep} * "
                    f"tp={max(1, cfg.tp)} exceeds {n} ranks"
                )
        tp = cfg.tp if cfg.tp > 0 else max(1, n // slots if n % slots == 0 else 1)
        while tp > 1 and (self.model_cfg.num_kv_heads % tp != 0
                          or self.model_cfg.vocab_size % tp != 0):
            tp -= 1
        return make_mesh(tp=tp, dp=cfg.dp, sp=cfg.sp, ep=cfg.ep)

    def _check_mesh(self, cfg: EngineConfig) -> None:
        """What a mesh refuses: CUDA graphs wherever a step holds a
        collective (tp, sp or ep > 1) over gloo, whose collectives run on
        the host and cannot be captured (pass cuda_graphs=False). Over NCCL,
        a card a rank, the steps capture with their collectives inside."""
        sharded = {a: self.mesh.shape[a] for a in (AXES.tp, AXES.sp, AXES.ep)
                   if self.mesh.shape[a] > 1}
        if sharded and cfg.cuda_graphs and self.mesh.backend != "nccl":
            raise ValueError(
                f"cuda_graphs=True at a mesh over {sharded} with the "
                f"{self.mesh.backend} backend: the steps hold collectives, and "
                "only NCCL's can be captured in a CUDA graph; pass "
                "cuda_graphs=False to run the steps eagerly")

    def _build_model(self, state: dict[str, torch.Tensor] | None = None) -> Llama:
        """Random weights from the seed, built on the device; or
        ``state``'s, or the checkpoint's, read (and quantized) on the host,
        then copied into a model built on the device, so the device never
        holds two copies. At a mesh, this rank's shard of any of them."""
        cfg = self.cfg
        if state is not None:
            model = Llama(self.model_cfg, cfg.dtype, self.device, seed=None,
                          quantize=cfg.quantize, mesh=self.mesh)
            model.load_full_state_dict(state)
            return model
        if not cfg.checkpoint:
            return Llama(self.model_cfg, cfg.dtype, self.device, seed=cfg.seed,
                         quantize=cfg.quantize, mesh=self.mesh)
        state = load_checkpoint(cfg.checkpoint, self.model_cfg, cfg.dtype,
                                device="cpu", quantize=cfg.quantize)
        model = Llama(self.model_cfg, cfg.dtype, self.device, seed=None,
                      quantize=cfg.quantize, mesh=self.mesh)
        model.load_full_state_dict(state)
        return model

    def impl_info(self) -> dict[str, str]:
        """The resolved execution modes (served on ``/healthz``)."""
        return {
            "attn_impl": self.attn_impl,
            "paged_backend": self.cfg.paged_backend,
            "device": str(self.device),
            "dtype": str(self.cfg.dtype).removeprefix("torch."),
            "quantize": self.cfg.quantize or "none",
            "kv_quantize": self.cfg.kv_quantize or "none",
            "cuda_graphs": str(self._replays()).lower(),
            "mesh": ",".join(f"{a}={n}" for a, n in self.mesh.shape.items() if n > 1)
                    or "one rank",
        }

    # -- host-side helpers ----------------------------------------------------
    def _sampling_arrays(
        self, seqs: list[Sequence | None], B: int
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        temps = np.zeros((B,), np.float32)
        top_k = np.zeros((B,), np.int32)
        top_p = np.ones((B,), np.float32)
        for i, s in enumerate(seqs):
            if s is not None:
                temps[i] = s.params.temperature
                top_k[i] = s.params.top_k
                top_p[i] = s.params.top_p
        return temps, top_k, top_p

    # -- request lifecycle -------------------------------------------------
    @_locked
    def add_request(
        self,
        prompt_ids: list[int],
        sampling: SamplingParams | None = None,
        mask_fn: MaskFn | None = None,
        stream: Callable[[int], None] | None = None,
    ) -> int:
        """Admit a request and prefill it whole (mixed steps with no decode
        lanes, or with ``mixed_batching`` off the split lane's chunks),
        sampling its first token. Returns the sequence id; raises
        OutOfPages when the page pool is full."""
        seq_id = self.begin_request(prompt_ids, sampling, mask_fn, stream)
        while seq_id in self._prefilling:
            if self.cfg.mixed_batching:
                self.step_mixed([], {seq_id: self.cfg.mixed_buckets[-1]})
            else:
                self.prefill_step(seq_id)
        return seq_id

    def begin_request(
        self,
        prompt_ids: list[int],
        sampling: SamplingParams | None = None,
        mask_fn: MaskFn | None = None,
        stream: Callable[[int], None] | None = None,
        trace: Any = None,
        expect_restore: bool = False,
    ) -> int:
        """Stage 1 of admission: allocate pages, reusing cached prefix pages
        and restoring pages of the host tier, and register the sequence as
        prefilling; mixed steps then run the rest of its prompt in chunks.
        ``mask_fn`` constrains the sequence's tokens (a mask that raises on
        the empty prefix is an invalid request); ``stream`` receives each
        accepted token; ``trace`` is the request's span, under which the
        engine records its phases; ``expect_restore`` marks a parked
        session's return, whose restore falling short is an anomaly."""
        sampling = sampling or SamplingParams()
        n = len(prompt_ids)
        window = self.model_cfg.max_position
        if n == 0:
            raise InvalidRequest("empty prompt")
        if n >= window:
            raise InvalidRequest(
                f"prompt of {n} tokens exceeds the model's "
                f"{window}-position context window"
            )
        if mask_fn is not None:
            try:
                mask_fn([])
            except Exception as e:  # noqa: BLE001 - the caller's callback
                raise InvalidRequest(f"mask_fn failed on the empty prefix: {e}") from e
        if n + sampling.max_tokens > window:
            sampling = replace(sampling, max_tokens=window - n)
        # Fleet-global KV: a prompt that misses the trie and the host pool
        # faults its chain in from a peer before the engine lock is taken
        # (the fetch is network or peer-engine work and must not hold up
        # this engine's ticks); the pages land in the host pool, where the
        # locked admission below restores them. Never raises.
        self.fault_in_prefix(prompt_ids, request_id=obs.flight.request_id_of(trace) or "")
        return self._admit(prompt_ids, sampling, mask_fn, stream, trace, expect_restore)

    @_locked
    def _admit(self, prompt_ids: list[int], sampling: SamplingParams,
               mask_fn: MaskFn | None, stream: Callable[[int], None] | None,
               trace: Any, expect_restore: bool) -> int:
        n = len(prompt_ids)
        if self.offload is not None:
            # Land the spills that are done; wait only for one that holds a
            # page of this prompt (a page parked during the last tick must
            # be matchable), not for the ticks in flight.
            self.offload.flush(wait=self.offload.pending_for(prompt_ids[: n - 1]))
        # Reuse full pages of the prompt minus its last token: at least one
        # token must run through the model to produce the next logits.
        prefix_pages = self.alloc.match_prefix(prompt_ids[: n - 1])
        matched = len(prefix_pages) * self.cfg.page_size
        seq_id = self.alloc.allocate(n, prefix_pages=prefix_pages)
        restored = self._restore_from_host(seq_id, prompt_ids, n, len(prefix_pages), matched)
        if expect_restore and matched + restored < (
                (n - 1) // self.cfg.page_size) * self.cfg.page_size:
            # A parked session came back and its host pages were gone
            # (dropped under the byte bound, or a failed restore): it
            # re-prefills, and that cost is recorded, not hidden.
            obs.OFFLOAD_RESTORE_FALLBACKS.inc()
            obs.flight.anomaly(
                "restore_reprefill", seq_id=seq_id, prompt_tokens=n,
                prefix_hit_tokens=matched, restored_tokens=restored,
                request_id=obs.flight.request_id_of(trace),
            )
        self.sequences[seq_id] = Sequence(
            seq_id, n, prompt_ids=list(prompt_ids), params=sampling,
            mask_fn=mask_fn, on_token=stream, trace=trace,
        )
        self._prefilling[seq_id] = matched + restored
        if matched:
            get_perf_stats().record_metric("engine.prefix_hit_tokens", matched, "tok")
            obs.PREFIX_HIT_TOKENS.inc(matched)
        obs.flight.record(
            "admission", seq_id=seq_id, prompt_tokens=n,
            prefix_hit_tokens=matched, restored_tokens=restored,
            request_id=obs.flight.request_id_of(trace),
        )
        self._observe_occupancy()
        return seq_id

    def _restore_from_host(
        self, seq_id: int, prompt_ids: list[int], n: int, shared_pages: int,
        matched: int,
    ) -> int:
        """Restore instead of re-prefill: pages of the prompt past the trie
        hit that the host pool holds are copied into the sequence's fresh
        pages and registered into the trie (``promote_prefix``), so that
        prefill starts after them and concurrent admissions hit them.
        Returns the tokens restored (0 on a miss or a failure: the chunked
        prefill then covers them)."""
        if self.offload is None:
            return 0
        seq_pages = self.alloc.pages_of(seq_id)
        entries = self.offload.pool.match(
            prompt_ids[: n - 1], start_page=shared_pages,
            max_pages=len(seq_pages) - shared_pages,
        )
        # Only whole pages of this cache's shapes go to the ranks: a restore
        # once published cannot fail on the leader alone.
        entries = list(itertools.takewhile(
            lambda e: self.offload.copier.fits(self.cache, e.data), entries))
        if not entries:
            return 0
        dst = seq_pages[shared_pages: shared_pages + len(entries)]
        try:
            restored = self._device("restore", dst, seq_id, data=entries)
        except Exception:  # noqa: BLE001 - falls back to re-prefill
            log.exception("host->device KV restore failed; re-prefilling "
                          "(the prefill chunks overwrite the pages)")
            return 0
        self.alloc.promote_prefix(seq_id, prompt_ids[: matched + restored])
        get_perf_stats().record_metric("engine.restore_tokens", restored, "tok")
        return restored

    def prefill_progress(self, seq_id: int) -> tuple[int, int]:
        """(prompt tokens already in cache, prompt length)."""
        return self._prefilling[seq_id], self.sequences[seq_id].prompt_len

    def _drop_admission(self, seq_id: int) -> None:
        self.sequences.pop(seq_id, None)
        self._prefilling.pop(seq_id, None)
        self.alloc.free(seq_id)

    @_locked
    def abort_request(self, seq_id: int) -> None:
        """Abandon a sequence that is still prefilling."""
        if seq_id in self._prefilling:
            self._drop_admission(seq_id)

    def _mixed_bucket(self, n: int) -> int:
        for b in self.cfg.mixed_buckets:
            if n <= b:
                return b
        return self.cfg.mixed_buckets[-1]

    def _host_written(self, seq: Sequence) -> int:
        """Tokens in the sequence's pages: the prompt and every accepted
        token but the last (it is written by the next step)."""
        return seq.prompt_len + max(0, len(seq.tokens) - 1)

    def _accept_token(self, seq: Sequence, token: int) -> None:
        seq.tokens.append(token)
        obs.DECODE_TOKENS.inc()
        now = time.perf_counter()
        if seq.last_tok_s:
            obs.ITL_SECONDS.observe(now - seq.last_tok_s)
            cls = obs.trace.class_of(seq.trace)
            if cls:
                obs.CLASS_ITL_SECONDS.observe(now - seq.last_tok_s, **{"class": cls})
        seq.last_tok_s = now
        if seq.params.presence_penalty or seq.params.frequency_penalty:
            seq.penalty_counts = self._seen(seq)
            seq.penalty_counts[token] = seq.penalty_counts.get(token, 0) + 1
        if seq.on_token is not None:
            try:
                seq.on_token(token)
            except Exception as e:  # noqa: BLE001 - ends this row, not the step
                log.exception("stream callback of sequence %d failed", seq.seq_id)
                seq.done, seq.finish_reason, seq.error = True, "error", e
                return
        if token == self.tokenizer.eos_id:
            seq.done, seq.finish_reason = True, "stop"
        elif len(seq.tokens) >= seq.params.max_tokens:
            seq.done, seq.finish_reason = True, "length"
        elif seq.params.stop and self._hit_stop_string(seq):
            seq.done, seq.finish_reason = True, "stop"
        if seq.done and seq.decode_span is not None:
            self._close_decode_span(seq)

    def _close_decode_span(self, seq: Sequence) -> None:
        obs.attribution.record_goodput(
            seq.decode_span.duration_s(), "decode_active",
            slo_class=obs.trace.class_of(seq.trace),
        )
        seq.decode_span.close(tokens=len(seq.tokens), finish_reason=seq.finish_reason)
        seq.decode_span = None

    def _hit_stop_string(self, seq: Sequence) -> bool:
        """Check the decoded tail for a stop string (a char may span up to 4
        byte tokens, so the window is sized in tokens)."""
        longest = max(len(s) for s in seq.params.stop)
        tail = self.tokenizer.decode(seq.tokens[-(longest * 4 + 8):])
        return any(s in tail for s in seq.params.stop)

    # -- logit bias, penalties, logprobs ---------------------------------------
    @staticmethod
    def _seen(s: Sequence) -> dict[int, int]:
        """The row's {token: count} for the penalties: its generated
        tokens, or ``penalty_history`` before the first one."""
        if s.penalty_counts is not None:
            return s.penalty_counts
        seen: dict[int, int] = {}
        for t in s.params.penalty_history:
            seen[t] = seen.get(t, 0) + 1
        return seen

    @staticmethod
    def _needs_bias(s: Sequence) -> bool:
        p = s.params
        return bool(p.logit_bias or p.presence_penalty or p.frequency_penalty)

    def _wants_extras(self, lanes: list[Sequence | None]) -> bool:
        """Whether a step over ``lanes`` takes the extras graph: a lane
        asks for a bias, a penalty or logprobs."""
        return any(s is not None and (s.params.logprobs or self._needs_bias(s))
                   for s in lanes)

    def _load_extras(self, lanes: list[Sequence | None]) -> bool:
        """Load ``SamplingExtras`` for one extras step over ``lanes`` (batch
        row i = lanes[i]; None where the row's token is not kept): the
        static bias, the token counts and the penalties of each lane that
        asks for them, zeros in the rows that held another's. Copies
        nothing when no row needs one now or held one before. Returns
        whether a lane asks for logprobs. Under inference mode."""
        x, V = self._extras, self.model_cfg.vocab_size
        want = {i: s for i, s in enumerate(lanes) if s is not None and self._needs_bias(s)}
        if want or self._extras_rows:
            bias: dict[int, np.ndarray] = {}
            counts: dict[int, np.ndarray] = {}
            pres = np.zeros(x.pres.shape, np.float64)
            freq = np.zeros(x.freq.shape, np.float64)
            for i, s in want.items():
                p = s.params
                if s.static_bias is None:
                    s.static_bias = np.zeros((V,), np.float32)
                    for tid, b in p.logit_bias:
                        if 0 <= tid < V:
                            s.static_bias[tid] += b
                bias[i] = s.static_bias
                if p.presence_penalty or p.frequency_penalty:
                    row = np.zeros((V,), np.float32)
                    for tid, c in self._seen(s).items():
                        if 0 <= tid < V:
                            row[tid] = c
                    counts[i] = row
                    pres[i], freq[i] = p.presence_penalty, p.frequency_penalty
            self._device("extras", sorted(self._extras_rows - want.keys()), bias, counts,
                         pres, freq)
            self._extras_rows = set(want)
        return any(s is not None and s.params.logprobs for s in lanes)

    @staticmethod
    def _logprob_entry(s: Sequence, lp, ids, top) -> dict:
        """One token's ``logprob_data`` entry from a row's pulled outputs."""
        n = min(s.params.top_logprobs, len(ids))
        return {"logprob": float(lp),
                "top": [(int(ids[k]), float(top[k])) for k in range(n)]}

    # -- constrained decoding -------------------------------------------------
    def _fsm_routes(self, seqs: list[Sequence]) -> dict[int, bool]:
        """For each constrained sequence of ``seqs``, by id: True when it
        rides the device tables this step, False when it is hosted. When no
        live sequence uses the loaded table set, the first sequence whose
        FSM has dense tables within the budget loads its own."""
        loaded = self._fsm_loaded
        in_use = loaded is not None and any(
            not s.done and isinstance(s.mask_fn, JsonConstraint) and s.mask_fn.fsm is loaded
            for s in self.sequences.values()
        )
        routes: dict[int, bool] = {}
        for s in seqs:
            if s.mask_fn is None:
                continue
            fsm = device_table_fsm(s.mask_fn)
            if fsm is not None and not in_use:
                if fsm is not loaded:
                    self._load_fsm(fsm)
                    loaded = fsm
                in_use = True
            routes[s.seq_id] = fsm is not None and fsm is loaded
        return routes

    def _load_fsm(self, fsm: TokenFSM) -> None:
        """Copy ``fsm``'s dense tables into the device buffers, on the
        calling thread and outside any capture. Where steps replay, into
        the capacity buffer (the budget guarantees the room); where they
        run eagerly, into buffers sized to the FSM."""
        mask, dest = fsm.dense_tables()
        t0 = time.perf_counter()
        self._device("fsm", mask, dest)
        self._fsm_loaded = fsm
        self.fsm_loads += 1
        self.fsm_load_s += time.perf_counter() - t0

    def _row_mask(self, s: Sequence) -> np.ndarray | None:
        """A hosted row's mask over the model's vocab (ids past the
        tokenizer's, a model's padded vocab, are forbidden), or None when
        its ``mask_fn`` raised: the row then ends with ``"error"``."""
        try:
            m = np.asarray(s.mask_fn(s.tokens), bool)
        except Exception:  # noqa: BLE001 - ends this row, not the step
            log.exception("mask_fn of sequence %d failed", s.seq_id)
            s.done, s.finish_reason = True, "error"
            return None
        row = np.zeros((self.model_cfg.vocab_size,), bool)
        n = min(len(m), len(row))
        row[:n] = m[:n]
        return row

    def _load_host_masks(self, masks: dict[int, np.ndarray]) -> None:
        """The host_mask buffer: ``masks`` by batch row, every other row
        all true. No copy when both the buffer and the call are all true.
        Under inference mode."""
        if not masks and not self._host_rows:
            return
        hm = np.ones(tuple(self._fsm.host_mask.shape), bool)
        for i, m in masks.items():
            hm[i] = m
        self._device("host_masks", hm)
        self._host_rows = bool(masks)

    def _fsm_row(self, s: Sequence, on_device: bool) -> int:
        """The row's FsmTables row: its DFA state + 1 on the device tables,
        else 0 (unconstrained or hosted)."""
        return s.mask_fn.dfa_state(s.tokens) + 1 if on_device else 0

    # -- the split prefill lane ------------------------------------------------
    def _bucket(self, n: int) -> int:
        """Smallest prefill bucket holding n tokens (a longer tail is
        chunked through the largest)."""
        for b in self.cfg.prefill_buckets:
            if n <= b:
                return b
        return self.cfg.prefill_buckets[-1]

    @_locked
    def next_prefill_bucket(self, seq_id: int) -> int:
        """The bucket the admitting sequence's next chunk pads to: the
        scheduler's grouping key for a batched chunk."""
        seq, done = self.sequences[seq_id], self._prefilling[seq_id]
        return self._bucket(min(seq.prompt_len - done, self.cfg.prefill_buckets[-1]))

    @_locked
    def prefill_batch(self, seq_ids: list[int]) -> dict[int, bool | Exception]:
        """One prefill chunk for each given admitting sequence in one
        dispatch (JAX's ``prefill_batch``; grouping same-bucket chunks is the
        caller's job, smaller chunks ride as padding). Rows pad to a power of
        two, padding rows writing through -1 tables; every row runs
        ``Llama.prefill_with_prefix`` (``start`` = tokens already in the
        cache, 0 for a fresh prompt) through the backend's ragged kernel,
        eagerly (no graph). A chunk that ends its prompt samples the first
        token with a mixed tick's sampler, constraint tables and extras
        (``pick_rows``).

        Returns {seq_id: prompt done | Exception}: a row whose ``mask_fn``
        or stream callback raises on the first token fails alone (its pages
        freed, its sequence dropped). A failed dispatch drops every row
        before the exception propagates. Async ticks in flight are settled
        first; pipelined blocks stay in flight (they hold other rows)."""
        self._async_settle()
        self._mixed_gap_stamp = None   # host-gap continuity ends here
        try:
            return self._prefill_chunk(seq_ids)
        except Exception:
            for sid in seq_ids:
                self._drop_admission(sid)
            raise

    def prefill_step(self, seq_id: int) -> bool:
        """One chunk of one admitting sequence (JAX's ``prefill_step``):
        True when its prompt is done and its first token sampled. The
        chunk runs as a one-row ``prefill_batch``, a fresh prompt's too
        (JAX runs that one through its ``prefill`` program). On failure the
        sequence is dropped and the exception propagates."""
        out = self.prefill_batch([seq_id])[seq_id]
        if isinstance(out, Exception):
            raise out
        return out

    def _staged(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device (through pinned memory on the
        card, so that the copy does not wait for the work enqueued)."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _prefill_chunk(self, seq_ids: list[int]) -> dict[int, bool | Exception]:
        B = self.cfg.max_batch_size
        if not 0 < len(seq_ids) <= B:
            raise ValueError(f"prefill batch of {len(seq_ids)} rows: expected 1.."
                             f"max_batch_size={B}")
        seqs = [self.sequences[s] for s in seq_ids]
        dones = [self._prefilling[s] for s in seq_ids]
        chunks = [min(seq.prompt_len - d, self.cfg.prefill_buckets[-1])
                  for seq, d in zip(seqs, dones)]
        bucket = self._bucket(max(chunks))
        Bp = 1
        while Bp < len(seq_ids):
            Bp *= 2
        tokens = np.full((Bp, bucket), self.tokenizer.pad_id, np.int64)
        starts = np.zeros((Bp,), np.int32)
        lens = np.zeros((Bp,), np.int32)
        tables = np.full((Bp, self.cfg.max_pages_per_seq), -1, np.int32)
        for i, (sid, seq, d, c) in enumerate(zip(seq_ids, seqs, dones, chunks)):
            tokens[i, :c] = seq.prompt_ids[d:d + c]
            starts[i], lens[i] = d, c
            tables[i] = self.alloc.page_table_row(sid)
        ending = [i for i, (seq, d, c) in enumerate(zip(seqs, dones, chunks))
                  if d + c >= seq.prompt_len]
        # A constrained row's mask_fn is screened before the dispatch: one
        # that raises fails its own row only.
        bad: dict[int, Exception] = {}
        for i in ending:
            if seqs[i].mask_fn is not None:
                try:
                    seqs[i].mask_fn(seqs[i].tokens)
                except Exception as e:  # noqa: BLE001 - the caller's callback
                    bad[i] = e
        ending = [i for i in ending if i not in bad]
        routes = self._fsm_routes([seqs[i] for i in ending])
        fsm = np.zeros((B,), np.int32)
        emits = np.zeros((B,), bool)
        masks: dict[int, np.ndarray] = {}
        for i in ending:
            s = seqs[i]
            emits[i] = True
            fsm[i] = self._fsm_row(s, routes.get(s.seq_id, False))
            if routes.get(s.seq_id) is False:
                masks[i] = self._row_mask(s)
        lanes: list[Sequence | None] = [s if emits[i] else None for i, s in enumerate(seqs)]
        temps, top_k, top_p = self._sampling_arrays(lanes, B)
        extras = self._wants_extras(lanes)
        sampled = lp = None
        want_lp = False
        if ending:
            self._load_host_masks(masks)
            want_lp = extras and self._load_extras(lanes)
        t0 = time.perf_counter()
        with torch.inference_mode():
            dev_out: list = []
            with annotate("engine.prefill_chunk"), device_timer("prefill_chunk", dev_out):
                tok = self._device(
                    "prefill", tokens, starts, lens, tables,
                    (fsm, emits, temps, top_k, top_p, extras) if ending else None,
                )
                dev_out.append(tok)
                if ending:
                    sampled = tok.cpu().numpy()
                    if want_lp:
                        x = self._extras
                        lp = (x.mixed_lp.cpu().numpy(), x.mixed_lp_ids.cpu().numpy(),
                              x.mixed_lp_top.cpu().numpy())
        self.prefill_dispatches += 1
        n_tokens = int(sum(chunks))
        perf = get_perf_stats()
        perf.record_metric("engine.prefill_chunk", (time.perf_counter() - t0) * 1e3, "ms")
        perf.record_metric("engine.prefill_tokens", n_tokens, "tok")
        obs.PREFILL_TOKENS.inc(n_tokens)
        obs.flight.record(
            "dispatch", op="prefill_batch", seq_ids=list(seq_ids), bucket=bucket,
            rows=len(seq_ids), prefill_tokens=n_tokens,
        )
        self.attr.dispatch(
            "prefill_batch",
            q_tokens=n_tokens,
            kv_read_tokens=int(sum(d + c for d, c in zip(dones, chunks))),
            kv_write_tokens=n_tokens,
            attn_q_ctx=int(sum(obs.attribution.prefill_attn_positions(d, c)
                               for d, c in zip(dones, chunks))),
        )
        out: dict[int, bool | Exception] = {}
        for i, (sid, seq, d, c) in enumerate(zip(seq_ids, seqs, dones, chunks)):
            if i in bad:
                self._drop_admission(sid)
                out[sid] = bad[i]
                continue
            if d + c < seq.prompt_len:
                self._prefilling[sid] = d + c
                out[sid] = False
                continue
            del self._prefilling[sid]
            seq.ttft_s = time.perf_counter() - seq.started_s
            perf.record_metric("engine.ttft", seq.ttft_s * 1e3, "ms")
            self._first_token_obs(seq)
            if lp is not None and seq.params.logprobs:
                seq.logprob_data.append(self._logprob_entry(seq, *(a[i] for a in lp)))
            self._accept_token(seq, int(sampled[i]))
            if seq.error is not None:
                # The stream callback raised on the first token.
                self._drop_admission(sid)
                out[sid] = seq.error
                continue
            out[sid] = True
        self._observe_occupancy()
        return out

    def _warm_prefill_lane(self) -> None:
        """Run each split-lane program once, every (rows, bucket) the
        scheduler can dispatch, over idle rows and -1 tables: the kernels'
        one-time set-up and the allocator's blocks at each shape, outside
        the serving window. The pages and the allocator are untouched."""
        ceil = 1
        while ceil < min(self.cfg.prefill_batch, self.cfg.max_batch_size):
            ceil *= 2
        rows = 1
        while rows <= ceil:
            for bucket in self.cfg.prefill_buckets:
                zero = np.zeros((rows,), np.int32)
                self.model.prefill_with_prefix(
                    self._staged(np.zeros((rows, bucket), np.int64)), self._staged(zero),
                    self._staged(zero), self.cache,
                    self._staged(np.full((rows, self.cfg.max_pages_per_seq), -1, np.int32)),
                    False, self.cfg.paged_backend,
                )
            rows *= 2

    # -- mixed prefill + decode step ----------------------------------------
    @_locked
    def step_mixed(
        self, decode_ids: list[int], prefill_chunks: dict[int, int]
    ) -> tuple[dict[int, list[int]], dict[int, bool]]:
        """ONE forward that advances every given decode lane by a token and
        runs one prefill chunk for each admitting sequence in
        ``prefill_chunks`` ({seq_id: chunk tokens}). Chunk rows pad to the
        smallest mixed bucket holding the largest chunk; decode rows ride at
        q_len 1. Constrained rows that emit (decode lanes, and chunks that
        end their prompt) sample under their mask.

        Returns ``(decode_out, prefill_out)``: ``decode_out`` maps each
        advanced decode sequence to its new token; ``prefill_out`` maps each
        chunk's sequence to True (prompt done, first token sampled) or
        False (more chunks to go). The async ticks and the pipelined blocks
        are settled first: their state would desync the rows' pages."""
        self._async_settle()
        if self._inflight or self._lane_of:
            self._flush_and_invalidate()
        decode = [
            self.sequences[s] for s in decode_ids
            if s in self.sequences and not self.sequences[s].done
        ]
        B = self.cfg.max_batch_size
        if len(decode) + len(prefill_chunks) > B:
            raise ValueError(
                f"mixed batch of {len(decode)} decode + {len(prefill_chunks)} "
                f"prefill rows exceeds max_batch_size={B}"
            )
        chunks: list[tuple[int, Sequence, int, int]] = []
        smax = 1
        for sid, want in prefill_chunks.items():
            seq, done = self.sequences[sid], self._prefilling[sid]
            c = min(want, self.cfg.mixed_buckets[-1], seq.prompt_len - done)
            chunks.append((sid, seq, done, c))
            smax = max(smax, c)
        ending = [seq for _, seq, done, c in chunks if done + c >= seq.prompt_len]
        ending_ids = {s.seq_id for s in ending}
        routes = self._fsm_routes(decode + ending)
        # Hosted rows' masks before any booking: a row whose mask fails
        # ends here (a decode row leaves the tick).
        host = {s.seq_id: self._row_mask(s) for s in decode + ending
                if routes.get(s.seq_id) is False}
        decode = [s for s in decode if not s.done]
        # Book the token each decode row is about to write; a row that
        # cannot grow finishes as truncated instead of failing the step.
        grown: list[Sequence] = []
        for s in decode:
            try:
                self.alloc.extend(s.seq_id, 1)
                grown.append(s)
            except OutOfPages:
                s.done, s.finish_reason = True, "length"
                self._preempted(s)
        decode = grown
        decode_out: dict[int, list[int]] = {}
        prefill_out: dict[int, bool] = {}
        if not decode and not prefill_chunks:
            return decode_out, prefill_out
        S = self._mixed_bucket(smax)
        tokens = np.full((B, S), self.tokenizer.pad_id, np.int64)
        starts = np.zeros((B,), np.int32)
        qlens = np.zeros((B,), np.int32)
        tables = np.full((B, self.cfg.max_pages_per_seq), -1, np.int32)
        fsm = np.zeros((B,), np.int32)
        emits = np.zeros((B,), bool)
        for i, s in enumerate(decode):
            tokens[i, 0] = s.tokens[-1] if s.tokens else self.tokenizer.bos_id
            # extend(1) made length = written + 1; the row writes at written.
            starts[i] = self.alloc.length(s.seq_id) - 1
            qlens[i] = 1
            tables[i] = self.alloc.page_table_row(s.seq_id)
        base = len(decode)
        for j, (sid, seq, done, c) in enumerate(chunks):
            tokens[base + j, :c] = seq.prompt_ids[done:done + c]
            starts[base + j] = done
            qlens[base + j] = c
            tables[base + j] = self.alloc.page_table_row(sid)
        slots: list[Sequence | None] = decode + [seq for _, seq, _, _ in chunks]
        masks: dict[int, np.ndarray] = {}
        for i, s in enumerate(slots):
            if s.done or (i >= base and s.seq_id not in ending_ids):
                continue  # a failed mask, or a chunk whose token is discarded
            emits[i] = True
            fsm[i] = self._fsm_row(s, routes.get(s.seq_id, False))
            if host.get(s.seq_id) is not None:
                masks[i] = host[s.seq_id]
        temps, top_k, top_p = self._sampling_arrays(slots, B)
        lanes = [s if emits[i] else None for i, s in enumerate(slots)]
        extras = self._wants_extras(lanes)
        lp = None
        perf = get_perf_stats()
        t_disp = time.perf_counter()
        # Host-gap observable: time since the previous mixed tick's replay
        # was enqueued, which in this synchronous tick spans its token pull
        # and all host work since.
        if self._mixed_gap_stamp is not None:
            gap = t_disp - self._mixed_gap_stamp
            obs.STEP_HOST_GAP_SECONDS.observe(gap, mode="sync")
            perf.record_metric("engine.step_host_gap", gap * 1e3, "ms")
        try:
            with torch.inference_mode():
                self._load_host_masks(masks)
                want_lp = extras and self._load_extras(lanes)
                # Every row samples; rows whose chunk does not finish the
                # prompt discard their token below.
                dev_out: list = [self._mixed[S].out]
                with annotate("engine.mixed_step"), device_timer("mixed_step", dev_out):
                    out = self._device(
                        "mixed", S, extras,
                        (tokens, starts, qlens, tables, temps, top_k, top_p, fsm, emits),
                    )
                self._mixed_gap_stamp = time.perf_counter()
                sampled = out.cpu().numpy()
                if want_lp:
                    x = self._extras
                    lp = (x.mixed_lp.cpu().numpy(), x.mixed_lp_ids.cpu().numpy(),
                          x.mixed_lp_top.cpu().numpy())
        except Exception:
            # Undo the decode rows' bookings (tokens never written) and drop
            # the chunk admissions before the failure propagates.
            for s in decode:
                if not s.done:
                    self.alloc.truncate(s.seq_id, self.alloc.length(s.seq_id) - 1)
            for sid, *_ in chunks:
                self._drop_admission(sid)
            raise
        measured_s = time.perf_counter() - t_disp
        perf.record_metric("engine.mixed_dispatch", measured_s * 1e3, "ms")
        n_prefill = sum(c for *_, c in chunks)
        if n_prefill:
            perf.record_metric("engine.prefill_tokens", n_prefill, "tok")
            obs.PREFILL_TOKENS.inc(n_prefill)
        # Attribution: decode lanes attend their whole written context;
        # chunk rows read their prefix + chunk. The tick's replay + pull
        # wall time is a synchronous measurement: it feeds the drift gauge.
        dec_ctx = sum(int(starts[i]) + 1 for i in range(len(decode)))
        record_mixed_dispatch(
            decode_rows=len(decode),
            prefill_tokens=n_prefill,
            budget=self.cfg.max_step_tokens,
            attr=self.attr,
            attr_kw=dict(
                q_tokens=len(decode) + n_prefill,
                kv_read_tokens=dec_ctx + sum(d + c for _, _, d, c in chunks),
                kv_write_tokens=len(decode) + n_prefill,
                attn_q_ctx=dec_ctx + sum(
                    obs.attribution.prefill_attn_positions(d, c)
                    for _, _, d, c in chunks
                ),
                measured_s=measured_s,
            ),
        )
        obs.flight.record(
            "dispatch", op="mixed",
            decode_seq_ids=[s.seq_id for s in decode],
            prefill_seq_ids=[sid for sid, *_ in chunks],
            bucket=int(S), prefill_tokens=n_prefill,
            budget=self.cfg.max_step_tokens,
        )
        for i, s in enumerate(decode):
            dspan = s.decode_span
            if lp is not None and s.params.logprobs:
                s.logprob_data.append(self._logprob_entry(s, *(a[i] for a in lp)))
            self._accept_token(s, int(sampled[i]))
            decode_out[s.seq_id] = [int(sampled[i])]
            if dspan is not None:
                dspan.child("mixed_step", t_disp, time.perf_counter(), tokens=1)
        for j, (sid, seq, done, c) in enumerate(chunks):
            prefill_out[sid] = done + c >= seq.prompt_len
            if not prefill_out[sid]:
                self._prefilling[sid] = done + c
                continue
            del self._prefilling[sid]
            if not seq.done:  # a failed mask ended it already
                seq.ttft_s = time.perf_counter() - seq.started_s
                perf.record_metric("engine.ttft", seq.ttft_s * 1e3, "ms")
                self._first_token_obs(seq)
                if lp is not None and seq.params.logprobs:
                    seq.logprob_data.append(
                        self._logprob_entry(seq, *(a[base + j] for a in lp)))
                self._accept_token(seq, int(sampled[base + j]))
        if decode:
            perf.record_metric("engine.decode_tokens", len(decode), "tok")
        self._observe_occupancy()
        return decode_out, prefill_out

    # -- block decode --------------------------------------------------------
    @_locked
    def step_block(self, seq_ids: list[int] | None = None) -> dict[int, list[int]]:
        """Advance running sequences by up to ``cfg.decode_block`` tokens a
        block. With ``pipeline_depth`` > 0 and every row plain or on the
        device FSM tables, the block is enqueued behind those in flight and
        the blocks past the depth are pulled (``_pipelined_block``): the
        tokens returned are those of earlier blocks. Otherwise the pipeline
        is drained and the block runs synchronously: hosted constrained
        rows advance one token first, in a one-step block of their own,
        and extras rows ride the extras graph. Returns {seq_id: accepted
        tokens}."""
        self._async_settle()
        # Host-gap continuity ends here: a block between two mixed ticks
        # would otherwise count as a gap.
        self._mixed_gap_stamp = None
        running = [
            s for s in self.sequences.values()
            if not s.done and s.seq_id not in self._prefilling
        ] if seq_ids is None else [
            self.sequences[i] for i in seq_ids if not self.sequences[i].done
        ]
        running = running[:self.cfg.max_batch_size]
        routes = self._fsm_routes(running)
        out: dict[int, list[int]] = {}
        if self.cfg.pipeline_depth > 0 and not any(
            routes.get(s.seq_id) is False or self._wants_extras([s]) for s in running
        ):
            out = self._pipelined_block(running, routes)
        else:
            if self._inflight or self._lane_of:
                self._flush_and_invalidate(out)
                running = [s for s in running if not s.done]
            hosted = [s for s in running if routes.get(s.seq_id) is False]
            rest = [s for s in running if routes.get(s.seq_id) is not False]
            if hosted:
                _merge_pulls(out, self._decode_rows(hosted, 1, routes))
            if rest:
                _merge_pulls(out, self._decode_rows(rest, self.cfg.decode_block, routes))
        self._observe_occupancy()
        return out

    # -- pipelined blocks ------------------------------------------------------
    def _pipelined_block(
        self, running: list[Sequence], routes: dict[int, bool],
    ) -> dict[int, list[int]]:
        """One block enqueued behind those in flight (JAX's pipelined
        ``step_block``), then the blocks past ``pipeline_depth`` pulled.
        Each row holds a lane for its life: a lane seated now starts from
        the host (its last token, written length, FSM row), every other
        carries its state over on the card. Budgets count the tokens in
        flight, so max_tokens is never passed; pages are booked for them
        and rolled back when a pull finds the row finished."""
        B, block = self.cfg.max_batch_size, self.cfg.decode_block
        out: dict[int, list[int]] = {}
        for lane, sid in enumerate(self._lanes):
            if sid is not None and (sid not in self.sequences or self.sequences[sid].done):
                self._free_lane(sid)
        override = np.zeros((B,), bool)
        ov_tok = np.zeros((B,), np.int64)
        ov_at = np.zeros((B,), np.int32)
        ov_fsm = np.zeros((B,), np.int32)
        for s in running:
            if s.seq_id in self._lane_of:
                continue
            try:
                lane = self._lanes.index(None)
            except ValueError:
                break  # more running sequences than lanes: they wait
            self._lanes[lane] = s.seq_id
            self._lane_of[s.seq_id] = lane
            override[lane] = True
            ov_tok[lane] = s.tokens[-1] if s.tokens else self.tokenizer.bos_id
            # Seated settled: the allocator's length is the written length.
            ov_at[lane] = self.alloc.length(s.seq_id)
            ov_fsm[lane] = self._fsm_row(s, routes.get(s.seq_id, False))
        # Lanes outside the caller's rows keep their carry but get no budget.
        requested = {s.seq_id for s in running}
        alive = np.zeros((B,), bool)
        budgets = np.zeros((B,), np.int32)
        lane_seqs: list[int | None] = [None] * B
        for lane, sid in enumerate(self._lanes):
            if sid is None:
                continue
            alive[lane] = True
            lane_seqs[lane] = sid
            s = self.sequences[sid]
            if sid not in requested or s.done:
                continue
            want = min(block, s.params.max_tokens - len(s.tokens)
                       - self._inflight_steps.get(sid, 0))
            if want <= 0:
                continue  # the blocks in flight cover its budget
            got = self.alloc.extend_upto(sid, want)
            if got == 0 and self._inflight:
                # A dry pool: the pulls may hold this row's tokens and roll
                # other finished rows' bookings back. Drain, then retry.
                while self._inflight:
                    _merge_pulls(out, self._pull_oldest())
                for lx, sx in enumerate(lane_seqs):
                    if sx is not None and (sx not in self.sequences
                                           or self.sequences[sx].done):
                        alive[lx], budgets[lx], lane_seqs[lx] = False, 0, None
                if s.done:
                    continue
                got = self.alloc.extend_upto(sid, want)
            if got == 0:
                s.done, s.finish_reason = True, "length"
                self._preempted(s)
                self.alloc.truncate(sid, self._host_written(s))
                self._free_lane(sid)
                alive[lane], override[lane], lane_seqs[lane] = False, False, None
                continue
            budgets[lane] = got
        if not budgets.any():
            # Nothing to enqueue; a pull still makes progress.
            if self._inflight:
                _merge_pulls(out, self._pull_oldest())
            return out
        table, _, _ = self.alloc.batch_views(lane_seqs, B)
        slots = [self.sequences.get(sid) if sid is not None else None for sid in lane_seqs]
        temps, top_k, top_p = self._sampling_arrays(slots, B)
        greedy = bool(np.all(temps <= 0.0))
        # JAX's routing: speculate when every seated lane is greedy and none
        # holds a constrained row.
        speculate = self._speculates(greedy, [self.sequences.get(sid) for sid in self._lanes])
        n_steps = int(budgets.max())
        counts = None
        t_disp = time.perf_counter()
        with torch.inference_mode():
            self._load_host_masks({})
            with annotate("engine.decode_block"):
                if speculate:
                    # An iteration emits at least one token a live row.
                    n_steps = min(self._spec_steps, n_steps)
                    history = {int(lane): self._history(self.sequences[self._lanes[lane]])
                               for lane in np.flatnonzero(override)}
                    toks_d, counts_d = self._device(
                        "spec", n_steps, ov_tok, ov_at, alive, budgets, table, history,
                        override,
                    )
                    host, _ = to_host(toks_d)
                    counts, event = to_host(counts_d)
                else:
                    toks_d = self._device(
                        "decode", greedy, False, n_steps, ov_tok, ov_at, alive, budgets,
                        table, temps, top_k, top_p, ov_fsm, override,
                    )
                    host, event = to_host(toks_d)
        get_perf_stats().record_metric(
            "engine.block_dispatch", (time.perf_counter() - t_disp) * 1e3, "ms")
        if speculate:
            self._count_spec_block()
        # Attribution as the sync block's, each budgeted lane's start being
        # its booked length less its budget; no measured time (enqueued).
        attr_q = attr_read = 0
        for lane, sid in enumerate(lane_seqs):
            b = int(budgets[lane])
            if sid is None or b == 0:
                continue
            s0 = max(0, self.alloc.length(sid) - b)
            attr_q += b
            attr_read += b * s0 + b * (b + 1) // 2
        record_dispatch(
            "spec" if speculate else "block", rows=int(np.count_nonzero(budgets)),
            steps=int(budgets.max()), attr=self.attr,
            attr_kw=dict(weight_streams=n_steps, q_tokens=attr_q, kv_read_tokens=attr_read,
                         kv_write_tokens=attr_q, attn_q_ctx=attr_read),
        )
        obs.flight.record(
            "dispatch", op="spec" if speculate else "decode_block",
            seq_ids=[sid for sid, b in zip(lane_seqs, budgets) if sid is not None and b],
            steps=int(budgets.max()),
        )
        self.pipelined_blocks += 1
        self._inflight.append((host, event, lane_seqs, budgets, t_disp, counts))
        for sid, b in zip(lane_seqs, budgets):
            if sid is not None and b:
                self._inflight_steps[sid] = self._inflight_steps.get(sid, 0) + int(b)
        while len(self._inflight) > self.cfg.pipeline_depth:
            _merge_pulls(out, self._pull_oldest())
        return out

    def _pull_oldest(self) -> dict[int, list[int]]:
        """Pull the oldest block in flight (its event alone is waited for)
        and fold its tokens into the host state. Blocks are pulled in
        order, so a row's EOS is seen before any later block of it."""
        host, event, lane_seqs, budgets, t_disp, counts = self._inflight.popleft()
        t0 = time.perf_counter()
        toks = from_host(host, event)
        if counts is not None:
            counts = counts.numpy()  # copied before the event
        perf = get_perf_stats()
        perf.record_metric("engine.block_pull", (time.perf_counter() - t0) * 1e3, "ms")
        out: dict[int, list[int]] = {}
        produced = 0
        for lane, sid in enumerate(lane_seqs):
            if sid is None or budgets[lane] == 0:
                continue
            left = self._inflight_steps.get(sid, 0) - int(budgets[lane])
            if left > 0:
                self._inflight_steps[sid] = left
            else:
                self._inflight_steps.pop(sid, None)
            s = self.sequences.get(sid)
            if s is None or s.done:
                continue  # finished while this block was in flight
            n0 = len(s.tokens)
            # The decode span open while the block ran, taken before the
            # accept loop can close it.
            dspan = s.decode_span
            self._accept_block(s, toks[lane], budgets[lane],
                               None if counts is None else counts[lane])
            out[sid] = s.tokens[n0:]
            produced += len(out[sid])
            if dspan is not None and out[sid]:
                dspan.child("decode_block", t_disp, time.perf_counter(),
                            tokens=len(out[sid]))
            if s.done:
                # Roll the bookings of the blocks in flight back to what
                # was written. Their stale writes land before any new
                # owner's: the card runs them in stream order.
                self.alloc.truncate(sid, self._host_written(s))
                self._free_lane(sid)
            elif counts is not None:
                # A speculative row emits at most its booking (draft
                # misses): roll back to what the blocks in flight may still
                # write, plus the k + 1 positions a verify writes past its
                # accepted count, or unspent bookings would drift without
                # bound and cut long generations short (JAX's rule).
                keep = (self._host_written(s) + self._inflight_steps.get(sid, 0)
                        + self.cfg.speculative_k + 1)
                if self.alloc.length(sid) > keep:
                    self.alloc.truncate(sid, keep)
        perf.record_metric("engine.decode_tokens", produced, "tok")
        self._observe_occupancy()
        return out

    def _accept_block(
        self, s: Sequence, toks: np.ndarray, budget: int, counts: np.ndarray | None,
    ) -> None:
        """Accept one row of a pulled block until the row finishes: a plain
        block's ``budget`` tokens, or each speculative iteration's
        ``counts`` tokens (pad past each count), recording each live
        iteration's count as ``engine.spec_step_tokens``: its mean less 1,
        over k, is the draft acceptance rate."""
        if counts is None:
            for j in range(int(budget)):
                self._accept_token(s, int(toks[j]))
                if s.done:
                    return
            return
        perf = get_perf_stats()
        for st, c in enumerate(counts):
            if c > 0:
                perf.record_metric("engine.spec_step_tokens", float(c), "tok")
            for j in range(int(c)):
                self._accept_token(s, int(toks[st, j]))
                if s.done:
                    return

    def _speculates(self, greedy: bool, rows: list[Sequence | None]) -> bool:
        """Whether a block over ``rows`` speculates: JAX's rule, greedy rows
        with ``speculative_k`` > 0 and none constrained."""
        return self._spec is not None and greedy and not any(
            s is not None and s.mask_fn is not None for s in rows
        )

    @staticmethod
    def _history(s: Sequence) -> list[int]:
        """A row's tokens by position, for drafting: the prompt and every
        accepted token."""
        return s.prompt_ids + s.tokens

    def _count_spec_block(self) -> None:
        self.spec_blocks += 1
        get_perf_stats().record_metric("engine.spec_blocks", 1, "blk")

    def _free_lane(self, seq_id: int) -> None:
        lane = self._lane_of.pop(seq_id, None)
        if lane is not None:
            self._lanes[lane] = None

    def _flush_and_invalidate(self, out: dict[int, list[int]] | None = None) -> None:
        """Pull every block in flight (their tokens merged into ``out``)
        and drop the lanes, rolling bookings back to what was written.
        Called before a synchronous step touches a lane's sequence: its
        bookkeeping would desync the carry."""
        while self._inflight:
            pulled = self._pull_oldest()
            if out is not None:
                _merge_pulls(out, pulled)
        for sid in list(self._lane_of):
            s = self.sequences.get(sid)
            if s is not None and not s.done:
                self.alloc.truncate(sid, self._host_written(s))
        self._lanes = [None] * self.cfg.max_batch_size
        self._lane_of.clear()

    @_locked
    def drain(self) -> dict[int, list[int]]:
        """Commit the async ticks and pull every block in flight, folding
        their tokens into the host state; returns the decode tokens (the
        async prefill outcomes stay for ``async_take_results``). Call before
        reading a sequence's final state outside the serving loop."""
        out: dict[int, list[int]] = {}
        if self._async.pending:
            _merge_pulls(out, self._async.drain_decode())
        while self._inflight:
            _merge_pulls(out, self._pull_oldest())
        return out

    # -- async mixed ticks (serving/async_runtime.py) -------------------------
    def _async_settle(self) -> None:
        """Commit every async tick in flight (the results wait for
        ``async_take_results``). The sync lanes call this before they touch
        state the lookahead may still reference."""
        if self._async.pending:
            self._async.flush()

    @_locked
    def step_mixed_async(
        self, decode_ids: list[int], prefill_chunks: dict[int, int]
    ) -> tuple[dict[int, list[int]], dict[int, bool]]:
        """``step_mixed``'s one-tick-lookahead form: enqueue this tick and
        return the results committed so far, which at ``async_depth`` > 1
        lag the enqueue by up to depth - 1 ticks (lists of tokens, since
        several commits may land in one call). Hosted rows are the caller's
        to route away (``mixed_async_hosted``)."""
        if self._inflight or self._lane_of:
            self._flush_and_invalidate()
        return self._async.step(decode_ids, prefill_chunks)

    @_locked
    def async_pending(self) -> int:
        """Enqueued, uncommitted async ticks."""
        return self._async.pending

    @_locked
    def async_take_results(self) -> tuple[dict[int, list[int]], dict[int, bool]]:
        """Results committed by settles since the last pickup: a finished
        admission must reach the scheduler even when a sync lane's settle
        committed it."""
        return self._async.take_results()

    @_locked
    def async_drain(self) -> tuple[dict[int, list[int]], dict[int, bool]]:
        """Commit every async tick and return everything committed."""
        self._async.flush()
        return self._async.take_results()

    @_locked
    def mixed_async_hosted(self, seq_id: int) -> bool:
        """True when the sequence cannot ride the async lane: it asks for
        logprobs, a bias or penalties, or its constraint has no device
        tables. Such rows route the tick to the sync lanes."""
        s = self.sequences.get(seq_id)
        if s is None:
            return False
        if s.params.logprobs or self._needs_bias(s):
            return True
        return s.mask_fn is not None and device_table_fsm(s.mask_fn) is None

    @_locked
    def async_row_fsm(self, seq_id: int) -> TokenFSM | None:
        """The device-table FSM behind the sequence's constraint, or None:
        the scheduler keeps each async tick on one table set."""
        s = self.sequences.get(seq_id)
        return None if s is None else device_table_fsm(s.mask_fn)

    # -- grammar fast-forward --------------------------------------------------
    def _note_ffwd_ineligible(self, s: Sequence) -> None:
        """Count a constrained row that cannot fast-forward (hosted mask,
        tables over the budget, logprobs, bias), once a sequence."""
        if s.seq_id in self._ffwd_noted:
            return
        self._ffwd_noted.add(s.seq_id)
        obs.ASYNC_FALLBACKS.inc(reason="ffwd_ineligible")

    @_locked
    def note_ffwd_ineligible(self, seq_id: int) -> None:
        """The scheduler's form of ``_note_ffwd_ineligible``."""
        s = self.sequences.get(seq_id)
        if s is not None:
            self._note_ffwd_ineligible(s)

    def _ffwd_candidate(self, s: Sequence) -> tuple[TokenFSM, list[int]] | None:
        """(fsm, forced run D) when the row can append a forced run now,
        else None. The append's inputs are ``[last token] + D`` and the
        masked sample after D is itself forced or free: a trailing EOS is
        cut off D (the sample at an EOS-only state is EOS at any
        temperature). D is clamped so that D and the sampled token never
        pass max_tokens or the largest mixed bucket."""
        if s.mask_fn is None or s.done or not s.tokens:
            return None
        if s.params.logprobs or self._needs_bias(s):
            self._note_ffwd_ineligible(s)
            return None
        fsm = device_table_fsm(s.mask_fn)
        if fsm is None:
            self._note_ffwd_ineligible(s)
            return None
        run = s.mask_fn.forced_run(s.tokens)
        if run and run[-1] == fsm.eos_id:
            run = run[:-1]
        room = s.params.max_tokens - len(s.tokens) - 1
        run = run[: max(0, min(room, self.cfg.mixed_buckets[-1] - 1))]
        return (fsm, run) if run else None

    @_locked
    def ffwd_step(self, seq_ids: list[int]) -> dict[int, list[int]]:
        """Grammar fast-forward: the constrained rows whose FSM state forces
        a run append it as one multi-token row of a mixed tick (the q_len >
        1 path of prefill chunks) and sample only the token after it, every
        forced token a forward skipped. Greedy output equals that with the
        feature off. Rows with tokens in flight have stale host tokens and
        are passed over, so nothing is settled unless a settled row has a
        run. Returns {seq_id: accepted tokens} (empty when no row could, and
        always with ``mixed_batching`` off: the appends ride mixed ticks)."""
        if not (self.cfg.grammar_ffwd and self.cfg.mixed_batching):
            return {}

        def scan(skip_inflight: bool) -> list[tuple]:
            found = []
            for sid in seq_ids:
                s = self.sequences.get(sid)
                if s is None or s.done:
                    continue
                if skip_inflight and (sid in self._inflight_steps
                                      or self._async.inflight_tokens(sid)):
                    continue
                cand = self._ffwd_candidate(s)
                if cand is not None:
                    found.append((s, *cand))
            return found

        if not scan(True):
            return {}
        self._async_settle()
        if self._inflight or self._lane_of:
            self._flush_and_invalidate()
        # Re-scan on the settled state: the pulls appended tokens.
        cands = scan(False)
        if not cands:
            return {}
        # One table set a tick: the loaded one (loading one if none is in
        # use); rows of another schema wait.
        routes = self._fsm_routes([s for s, *_ in cands])
        cands = [c for c in cands if routes.get(c[0].seq_id)][: self.cfg.max_batch_size]
        rows: list[tuple[Sequence, list[int]]] = []
        for s, _fsm, run in cands:
            try:
                self.alloc.extend(s.seq_id, 1 + len(run))
            except OutOfPages:
                # Leave the row to normal decode, which finishes it as
                # "length" if the pool stays dry.
                self.alloc.truncate(s.seq_id, self._host_written(s))
                continue
            rows.append((s, run))
        if not rows:
            return {}
        B = self.cfg.max_batch_size
        S = self._mixed_bucket(max(1 + len(r) for _, r in rows))
        tokens = np.full((B, S), self.tokenizer.pad_id, np.int64)
        starts = np.zeros((B,), np.int32)
        qlens = np.zeros((B,), np.int32)
        emits = np.zeros((B,), bool)
        fsm = np.zeros((B,), np.int32)
        tables = np.full((B, self.cfg.max_pages_per_seq), -1, np.int32)
        for i, (s, run) in enumerate(rows):
            q = 1 + len(run)
            tokens[i, :q] = [s.tokens[-1]] + run
            # The extend made length = written + q; the row writes its q
            # inputs from the written offset.
            starts[i] = self.alloc.length(s.seq_id) - q
            qlens[i] = q
            emits[i] = True
            tables[i] = self.alloc.page_table_row(s.seq_id)
            # The sample masks by the state after the run.
            fsm[i] = s.mask_fn.dfa_state(s.tokens + run) + 1
        slots: list[Sequence | None] = [s for s, _ in rows] + [None] * (B - len(rows))
        temps, top_k, top_p = self._sampling_arrays(slots, B)
        perf = get_perf_stats()
        t_disp = time.perf_counter()
        try:
            with torch.inference_mode():
                self._load_host_masks({})
                dev_out: list = [self._mixed[S].out]
                with annotate("engine.ffwd_step"), device_timer("ffwd_step", dev_out):
                    out = self._device(
                        "mixed", S, False,
                        (tokens, starts, qlens, tables, temps, top_k, top_p, fsm, emits),
                    )
                self._mixed_gap_stamp = time.perf_counter()
                sampled = out.cpu().numpy()
        except Exception:
            # Nothing was accepted: roll every booking back.
            for s, _run in rows:
                self.alloc.truncate(s.seq_id, self._host_written(s))
            raise
        measured_s = time.perf_counter() - t_disp
        perf.record_metric("engine.ffwd_dispatch", measured_s * 1e3, "ms")
        obs.DECODE_DISPATCHES.inc(kind="ffwd")
        n_forced = sum(len(r) for _, r in rows)
        self.ffwd_dispatches += 1
        self.ffwd_tokens += n_forced
        q_total = n_forced + len(rows)
        self.attr.dispatch(
            "ffwd_append", q_tokens=q_total,
            kv_read_tokens=int(sum(int(starts[i]) + int(qlens[i]) for i in range(len(rows)))),
            kv_write_tokens=q_total,
            attn_q_ctx=int(sum(obs.attribution.prefill_attn_positions(
                int(starts[i]), int(qlens[i])) for i in range(len(rows)))),
            measured_s=measured_s,
        )
        obs.flight.record("dispatch", op="ffwd", decode_seq_ids=[s.seq_id for s, _ in rows],
                          bucket=int(S), forced_tokens=n_forced)
        out: dict[int, list[int]] = {}
        produced = 0
        for i, (s, run) in enumerate(rows):
            n0 = len(s.tokens)
            dspan = s.decode_span
            for t in run + [int(sampled[i])]:
                if s.done:
                    break
                self._accept_token(s, t)
            accepted = s.tokens[n0:]
            if s.done:
                # A stop string, EOS or max_tokens inside the run: the
                # booked tail is dead, roll it back.
                self.alloc.truncate(s.seq_id, self._host_written(s))
            n_ff = min(len(accepted), len(run))
            if n_ff:
                record_ffwd_append(s.seq_id, n_ff, attr=self.attr,
                                   request_id=obs.flight.request_id_of(s.trace))
            if dspan is not None:
                dspan.child("ffwd_step", t_disp, time.perf_counter(), tokens=len(accepted))
            out[s.seq_id] = accepted
            produced += len(accepted)
        if produced:
            perf.record_metric("engine.decode_tokens", produced, "tok")
        self._observe_occupancy()
        return out

    def _decode_rows(
        self, seqs: list[Sequence], block: int, routes: dict[int, bool],
    ) -> dict[int, list[int]]:
        """One ``decode_block`` over ``seqs`` (batch row i = seqs[i]) of up
        to ``block`` steps. Hosted rows (``routes`` False) sample under
        their host-computed masks."""
        B = self.cfg.max_batch_size
        masks = {i: self._row_mask(s) for i, s in enumerate(seqs)
                 if routes.get(s.seq_id) is False}
        tokens = np.zeros((B,), np.int64)
        write_at = np.zeros((B,), np.int32)
        budgets = np.zeros((B,), np.int32)
        fsm = np.zeros((B,), np.int32)
        lanes: list[Sequence | None] = [None] * B
        for i, s in enumerate(seqs):
            if s.done:  # its mask failed
                masks.pop(i, None)
                continue
            want = min(block, s.params.max_tokens - len(s.tokens))
            got = self.alloc.extend_upto(s.seq_id, want) if want > 0 else 0
            if got == 0:
                s.done, s.finish_reason = True, "length"
                if want > 0:
                    self._preempted(s)
                self.alloc.truncate(s.seq_id, self._host_written(s))
                masks.pop(i, None)
                continue
            lanes[i] = s
            tokens[i] = s.tokens[-1] if s.tokens else self.tokenizer.bos_id
            write_at[i] = self._host_written(s)
            budgets[i] = got
            fsm[i] = self._fsm_row(s, routes.get(s.seq_id, False))
        if not budgets.any():
            return {}
        table, _, active = self.alloc.batch_views(
            [s.seq_id if s is not None else None for s in lanes], B
        )
        temps, top_k, top_p = self._sampling_arrays(lanes, B)
        greedy = bool(np.all(temps <= 0.0))
        extras = self._wants_extras(lanes)
        speculate = not extras and self._speculates(greedy, lanes)
        n_steps = int(budgets.max())
        counts = None
        t_disp = time.perf_counter()
        with torch.inference_mode():
            if speculate:
                # An iteration emits at least one token a live row.
                n_steps = min(self._spec_steps, n_steps)
            self.hosted_steps += len(masks) * n_steps
            self._load_host_masks(masks)
            want_lp = extras and self._load_extras(lanes)
            dev_out: list = [self._decode.out]
            with annotate("engine.decode_block"), device_timer("decode_block", dev_out):
                if speculate:
                    history = {i: self._history(s) for i, s in enumerate(lanes) if s is not None}
                    toks_d, counts_d = self._device(
                        "spec", n_steps, tokens, write_at, active, budgets, table, history,
                        None,
                    )
                    counts = counts_d.cpu().numpy()
                else:
                    toks_d = self._device(
                        "decode", greedy, extras, n_steps, tokens, write_at, active,
                        budgets, table, temps, top_k, top_p, fsm, None,
                    )
            toks = toks_d.cpu().numpy()
            lp = None
            if want_lp:
                x = self._extras
                lp = (x.lp[:, :n_steps].cpu().numpy(), x.lp_ids[:, :n_steps].cpu().numpy(),
                      x.lp_top[:, :n_steps].cpu().numpy())
        measured_s = time.perf_counter() - t_disp
        get_perf_stats().record_metric("engine.block_dispatch", measured_s * 1e3, "ms")
        if speculate:
            self._count_spec_block()
        # Attribution: each budgeted lane writes b tokens, its step j
        # attending start + j + 1 positions (exact causal sum); the block
        # streams the weights once per step, however few lanes carry a
        # budget (inactive lanes ride the stream).
        attr_q = attr_read = 0
        for i, s in enumerate(lanes):
            b = int(budgets[i])
            if s is None or b == 0:
                continue
            attr_q += b
            attr_read += b * int(write_at[i]) + b * (b + 1) // 2
        record_dispatch(
            "spec" if speculate else "block", rows=int(np.count_nonzero(budgets)),
            steps=int(budgets.max()), attr=self.attr,
            attr_kw=dict(
                weight_streams=n_steps, q_tokens=attr_q, kv_read_tokens=attr_read,
                kv_write_tokens=attr_q, attn_q_ctx=attr_read, measured_s=measured_s,
            ),
        )
        obs.flight.record(
            "dispatch", op="spec" if speculate else "decode_block",
            seq_ids=[s.seq_id for i, s in enumerate(lanes) if s is not None and budgets[i]],
            steps=int(budgets.max()),
        )
        out: dict[int, list[int]] = {}
        produced = 0
        for i, s in enumerate(lanes):
            if s is None:
                continue
            n0 = len(s.tokens)
            # The decode span open while the block ran, taken before the
            # accept loop can close it (EOS mid-block).
            dspan = s.decode_span
            if lp is not None:
                for j in range(int(budgets[i])):
                    if s.params.logprobs:
                        s.logprob_data.append(self._logprob_entry(s, *(a[i, j] for a in lp)))
                    self._accept_token(s, int(toks[i, j]))
                    if s.done:
                        break
            else:
                self._accept_block(s, toks[i], budgets[i],
                                   None if counts is None else counts[i])
            out[s.seq_id] = s.tokens[n0:]
            produced += len(out[s.seq_id])
            if dspan is not None and out[s.seq_id]:
                dspan.child("decode_block", t_disp, time.perf_counter(),
                            tokens=len(out[s.seq_id]))
            if s.done or counts is not None:
                # Roll the block's booking back to what was written (a
                # speculative row may have spent less than it booked).
                self.alloc.truncate(s.seq_id, self._host_written(s))
        get_perf_stats().record_metric("engine.decode_tokens", produced, "tok")
        return out

    # -- warmup and the step graphs -------------------------------------------
    def warmup(self) -> float:
        """Prepare the serving programs before the first request (the
        counterpart of the JAX engine's ``warmup``): builds the kernels and
        runs each step body eagerly twice (the decode step greedy and
        sampled, the mixed tick at every bucket, each with and without the
        sampler extras, and with ``speculative_k`` the speculative
        iteration) over an all -1 page table
        with every row inactive, so that each kernel instance's one-time
        set-up and the split calls' workspaces happen outside a capture;
        then, on the card with the kernels, captures each body as a CUDA
        graph. The warm steps write only the cache's scratch slot and draw
        from a spare generator: the cache's pages, the allocator and the
        engine's generator are untouched. With ``mixed_batching`` off and
        the kernels, each split-lane program (``prefill_batch``: every
        padded row count and bucket) also runs once, eagerly. Call it
        before other threads touch CUDA (a capture is process-wide).
        Returns wall seconds spent."""
        t0 = time.perf_counter()
        # Compile-watchdog phase bracket: captures and kernel builds inside
        # count as "warmup"; once any warmup completes, one during serving
        # is an anomaly.
        with obs.flight.warmup_phase(), self.lock, torch.inference_mode():
            self._device("warmup")
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        get_perf_stats().record_metric("engine.warmup", dt * 1e3, "ms")
        obs.flight.record("warmup", level="full", seconds=round(dt, 3))
        self.init_stats["warmup_s"] = round(self.init_stats["warmup_s"] + dt, 3)
        return dt

    # -- snapshot and restore (serving/snapshot) -----------------------------
    def snapshot(self, path: str) -> dict:
        """Write this engine's restart snapshot under ``path``: the weights
        in the JAX package's leaf layout, the built kernel libraries and
        the paged-KV plan. Returns the manifest."""
        with self.lock:
            return self._device("snapshot", path)

    @classmethod
    def from_snapshot(
        cls, path: str, warmup: bool = False, tokenizer: Tokenizer | None = None,
        device: str | None = None, host_pool_bytes: int = 0, eager: bool = False,
    ) -> "Engine":
        """Restore an engine from a snapshot directory (the port's or the
        JAX package's): weight files memory-mapped into the model, the
        kernel libraries pre-seeded so that no ``nvcc`` runs, ``warmup``
        to recapture the graphs (on the leader; a follower warms up as it
        follows). A snapshot written at a mesh restores in a job of as many
        ranks, every rank calling this. Refuses a mismatched fingerprint,
        world size, card count or leaf order, and a truncated leaf, with a
        ``SnapshotError``. ``host_pool_bytes`` bounds the host tier of a
        snapshot taken with ``offload`` (not part of the fingerprint);
        ``eager`` runs the steps without CUDA graphs (a gloo mesh must)."""
        from .snapshot.restore import restore_engine

        return restore_engine(path, warmup=warmup, tokenizer=tokenizer, device=device,
                              host_pool_bytes=host_pool_bytes, eager=eager)

    # -- the device steps: one choke point (serving.spmd) ---------------------
    def _device(self, op: str, *args, data: Any = None):
        """Run the device op ``op`` (``_op_<op>``) over its host inputs
        ``args``: every step, every load of the step state and every host
        KV tier copy goes through here. At a mesh of several ranks the
        leader first publishes the record, and each follower runs the same
        op on its shard (``follow``). ``data`` goes to the leader's op only
        (as ``data=``), never into the record: what only the leader holds
        (host pages, token chains); a follower's op runs with ``data``
        None."""
        if self._channel is not None:
            if not self.mesh.leader:
                raise RuntimeError("a follower rank runs steps through follow() only")
            self._channel.publish(op, args)
        fn = getattr(self, f"_op_{op}")
        with torch.inference_mode():
            out = fn(*args) if data is None else fn(*args, data=data)
        if self.spmd_outputs is not None:
            self.spmd_outputs.append((op, spmd.kept(out)))
        return out

    def follow(self) -> int:
        """A follower rank's loop: receive the leader's step records and run
        each op on this rank's shards, until a ``stop`` record. Returns the
        ops run. An op that raises ends the loop with the exception (the
        leader then raises from its next collective)."""
        if self._channel is None or self.mesh.leader:
            raise RuntimeError("follow() runs on a follower rank of a mesh")
        ran = 0
        with self.lock:
            while True:
                op, args = self._channel.receive()
                if op == spmd.STOP:
                    return ran
                faults.maybe_raise("spmd.follower_step", RuntimeError, op=op)
                with torch.inference_mode():
                    out = getattr(self, f"_op_{op}")(*args)
                if self.spmd_outputs is not None:
                    self.spmd_outputs.append((op, spmd.kept(out)))
                ran += 1

    def stop_followers(self) -> None:
        """The leader's last record: the followers' ``follow`` returns.
        Once; a one-rank engine has none."""
        if self._channel is not None and self.mesh.leader and not self._stopped:
            self._stopped = True
            self._channel.publish(spmd.STOP, ())

    def _op_spill(self, pages: list[int], trigger: str,
                  data: list[tuple[int, ...]] | None = None) -> None:
        """Gather ``pages`` for the host tier (``_spill``): the leader's
        ``data`` holds each page's token chain, the pool key; a follower
        gathers its heads of them for the leader's pages."""
        if data is None:
            self.offload.copier.dispatch_gather(self.cache, pages, [None] * len(pages))
        else:
            self.offload.spill(self.cache, list(zip(pages, data)), trigger=trigger)

    def _op_restore(self, pages: list[int], seq_id: int | None,
                    data: list | None = None) -> int:
        """Write host pool entries (the leader's ``data``) into device
        ``pages``; a follower writes its heads of the leader's pages.
        Returns the tokens restored (0 on a follower)."""
        if data is None:
            self.offload.copier.scatter(self.cache, pages, None)
            return 0
        return self.offload.restore(self.cache, pages, data, seq_id=seq_id)

    def _op_snapshot(self, path: str) -> dict:
        """Write the snapshot (``serving.snapshot.writer``): at a mesh every
        rank gathers each leaf from its shards and the leader writes it."""
        from .snapshot.writer import write_snapshot

        return write_snapshot(self, path)

    def _op_fsm(self, mask: np.ndarray, dest: np.ndarray) -> None:
        """Load a constraint's dense tables (``_load_fsm``). Where steps
        replay, into the capacity buffer (the budget guarantees the room);
        where they run eagerly, into buffers sized to the FSM."""
        if mask.shape[0] > self._fsm.rows and not self._replays():
            self._fsm = FsmTables.empty(
                self.cfg.max_batch_size, self.model_cfg.vocab_size, mask.shape[0],
                self.device,
            )
            self._host_rows = False
        self._fsm.load(mask, dest)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _op_host_masks(self, hm: np.ndarray) -> None:
        self._fsm.host_mask.copy_(torch.from_numpy(hm))

    def _op_extras(self, zero: list[int], bias: dict[int, np.ndarray],
                   counts: dict[int, np.ndarray], pres: np.ndarray,
                   freq: np.ndarray) -> None:
        """``SamplingExtras``' rows: ``zero`` rows' bias cleared, ``bias``
        and ``counts`` rows set, the penalties loaded."""
        x = self._extras
        for i in zero:
            x.bias[i].zero_()
        for i, row in bias.items():
            x.bias[i].copy_(torch.from_numpy(row))
        for i, row in counts.items():
            x.counts[i].copy_(torch.from_numpy(row))
        x.pres.copy_(torch.from_numpy(pres))
        x.freq.copy_(torch.from_numpy(freq))

    def _op_prefill(self, tokens, starts, lens, tables, sampling) -> torch.Tensor:
        """A split-lane chunk (``_prefill_chunk``): the forward, and with
        ``sampling`` (fsm, emits, temps, top_k, top_p, extras) each row's
        first token [B]; without it the logits. A chunk of fresh prompts
        at sp > 1 runs ``Llama.prefill`` with ring attention, as JAX's
        fresh ``prefill_step`` does; every other chunk the prefix form
        through the ragged kernel."""
        plain = self.attn_impl == "plain"
        if self._prefill_attn is not None and not starts.any():
            logits = self.model.prefill(
                self._staged(tokens), self._staged(lens), self.cache, self._staged(tables),
                plain, prefill_attn=self._prefill_attn,
            )
        else:
            logits = self.model.prefill_with_prefix(
                self._staged(tokens), self._staged(starts), self._staged(lens),
                self.cache, self._staged(tables), plain, self.cfg.paged_backend,
            )
        if sampling is None:
            return logits
        fsm, emits, temps, top_k, top_p, extras = sampling
        # Every batch row samples (padding rows greedily, their tokens
        # discarded): the sampler's buffers are [B].
        B, Bp, V = self.cfg.max_batch_size, logits.shape[0], logits.shape[1]
        rows = logits[:B] if Bp >= B else torch.cat([logits, logits.new_zeros((B - Bp, V))])
        return pick_rows(
            rows, self._staged(fsm), self._staged(emits), self._staged(temps),
            self._staged(top_k), self._staged(top_p), self._prefill_generator,
            self._fsm, self._extras if extras else None,
        )

    def _op_mixed(self, S: int, extras: bool, inputs: tuple,
                  carry: int | None = None) -> torch.Tensor:
        """One mixed tick at bucket ``S``: the step state loaded from the
        host ``inputs`` (``MixedState.load``'s arguments from ``tokens`` to
        ``use_carry``), with ``carry`` the bucket whose previous tick's
        outputs carry over (the async ticks), then the tick; its tokens [B]
        on the device."""
        step = self._mixed_step(S, extras)
        state = self._mixed[S]
        state.load(*inputs, carry=None if carry is None else self._mixed[carry])
        step()
        return state.out

    def _op_decode(self, greedy: bool, extras: bool, n_steps: int, tokens, write_at,
                   active, budgets, table, temps, top_k, top_p, fsm, override):
        """A decode block (``decode_block``; ``override`` its carry form):
        its tokens [B, n_steps] on the device."""
        return decode_block(
            self._decode, self._decode_step(greedy, extras, n_steps), tokens, write_at,
            active, budgets, table, temps, top_k, top_p, n_steps=n_steps, fsm=fsm,
            override=override,
        )

    def _op_spec(self, n_steps: int, tokens, write_at, active, budgets, table, history,
                 override):
        """A speculative block (``speculative_block``): its tokens and each
        step's counts on the device."""
        return speculative_block(
            self._decode, self._spec, self._spec_step(n_steps), tokens, write_at, active,
            budgets, table, n_steps, history, override=override,
        )

    def _op_warmup(self) -> None:
        """``warmup``'s device work: the warm steps and the captures, with
        the kernels and the split lane its programs, and with the host KV
        tier the staging and pinned buffers of every copy bucket."""
        self._prepare()
        if self.offload is not None:
            self.offload.copier.warm(self.cache)
        if self.attn_impl == "cuda" and not self.cfg.mixed_batching:
            # The split lane admits every prompt: its programs run once here
            # (eagerly; they are never captured).
            self._warm_prefill_lane()

    def _replays(self) -> bool:
        return self.attn_impl == "cuda" and self.cfg.cuda_graphs

    def _mixed_step(self, S: int, extras: bool = False):
        """The mixed tick at bucket ``S``: its graph's replay where steps
        replay, else its eager body; counted as one either way."""
        if self._replays():
            self.mixed_replays += 1
            return self._prepare()[("mixed", S, extras)].replay
        self.mixed_eager_ticks += 1
        return self._mixed_body(S, extras, self._generator)

    def _decode_step(self, greedy: bool, extras: bool, n_steps: int):
        """The decode step, as ``_mixed_step``, counted ``n_steps`` times."""
        if self._replays():
            self.decode_replays += n_steps
            return self._prepare()[("decode", greedy, extras)].replay
        self.decode_eager_steps += n_steps
        return self._decode_body(greedy, extras, self._generator)

    def _spec_step(self, n_steps: int):
        """The speculative iteration, as ``_decode_step``, counted
        ``n_steps`` times."""
        if self._replays():
            self.spec_replays += n_steps
            return self._prepare()[("spec", True, False)].replay
        self.spec_eager_steps += n_steps
        return self._spec_body()

    def _prepare(self) -> dict[tuple[str, object], StepGraph]:
        """The warm steps, then the captures where steps replay; once per
        engine. Returns the graphs (none where steps run eagerly)."""
        if self._warm:
            return self._graphs
        B, max_pages = self.cfg.max_batch_size, self.cfg.max_pages_per_seq
        idle = np.zeros((B,), np.int32)
        table = np.full((B, max_pages), -1, np.int32)
        sampling = (idle.astype(np.float32), idle, np.ones((B,), np.float32))
        spare = torch.Generator(device=self.device)
        bodies = {}
        for greedy, extras in itertools.product((True, False), (False, True)):
            for _ in range(2):
                decode_block(
                    self._decode, self._decode_body(greedy, extras, spare), idle, idle,
                    idle.astype(bool), idle, table, *sampling, n_steps=1,
                )
            bodies["decode", greedy, extras] = (
                self._decode, self._decode_body(greedy, extras, self._generator)
            )
        if self._spec is not None:
            for _ in range(2):
                speculative_block(self._decode, self._spec, self._spec_body(), idle, idle,
                                  idle.astype(bool), idle, table, 1, {})
            bodies["spec", True, False] = ((self._decode, self._spec), self._spec_body())
        for S, state in self._mixed.items():
            state.load(np.zeros((B, S), np.int64), idle, idle, table, *sampling)
            for extras in (False, True):
                for _ in range(2):
                    self._mixed_body(S, extras, spare)()
                bodies["mixed", S, extras] = (
                    state, self._mixed_body(S, extras, self._generator))
        if self._replays():
            for key, (state, body) in bodies.items():
                # The greedy steps draw no random numbers.
                gen = None if key[1] is True else self._generator
                if key[0] == "spec":
                    buffers = state
                else:
                    buffers = (state, self._fsm) + ((self._extras,) if key[2] else ())
                self._graphs[key] = StepGraph(body, buffers, self.cache, gen,
                                              collectives=self.mesh.size > 1)
            torch.cuda.synchronize(self.device)
        self._warm = True
        return self._graphs

    def _decode_body(self, greedy: bool, extras: bool, generator: torch.Generator):
        """The block's step, eager: ``decode_step_body`` over the engine's
        state, constraint tables and cache, and with ``extras`` its sampler
        extras."""
        return partial(
            decode_step_body, self.model, self._decode, self.cache, generator,
            self.tokenizer.eos_id, self.tokenizer.pad_id, greedy,
            self.attn_impl == "plain", self.cfg.paged_backend, tables=self._fsm,
            extras=self._extras if extras else None,
        )

    def _spec_body(self):
        """The speculative iteration, eager: ``speculative_step_body`` over
        the engine's decode state, speculative buffers and cache."""
        return partial(
            speculative_step_body, self.model, self._decode, self._spec, self.cache,
            self.tokenizer.eos_id, self.tokenizer.pad_id, self.cfg.speculative_ngram,
            self.attn_impl == "plain", self.cfg.paged_backend,
        )

    def _mixed_body(self, S: int, extras: bool, generator: torch.Generator):
        """The mixed tick at bucket ``S``, eager: ``mixed_step_body`` over
        that bucket's state, the constraint tables and the engine's cache,
        and with ``extras`` its sampler extras."""
        return partial(
            mixed_step_body, self.model, self._mixed[S], self.cache, generator,
            self.attn_impl == "plain", self.cfg.paged_backend, tables=self._fsm,
            extras=self._extras if extras else None,
        )

    @_locked
    def finish(self, seq_id: int) -> list[int]:
        """Release a sequence; returns its generated tokens. Full pages go
        to the prefix trie keyed by the tokens they hold (the prompt and all
        generated tokens but the last, which was never written)."""
        seq = self.sequences.pop(seq_id)
        self._ffwd_noted.discard(seq_id)
        self.alloc.free(seq_id, tokens=seq.prompt_ids + seq.tokens[:-1])
        obs.flight.record(
            "finish", seq_id=seq_id, tokens=len(seq.tokens),
            finish_reason=seq.finish_reason,
            request_id=obs.flight.request_id_of(seq.trace),
        )
        if seq.decode_span is not None:
            # An errored sequence reaches finish() with its span open.
            self._close_decode_span(seq)
        self._observe_occupancy()
        return seq.tokens

    # -- host KV tier (serving/offload) ----------------------------------------
    def _spill_page(self, page: int, chain_tokens: list[int]) -> None:
        """The allocator's eviction hook: enqueue a device->host copy of the
        page being dropped, keyed by its token chain. Runs under the engine
        lock inside allocate/extend, so the gather precedes any later write
        to the recycled page (a park collects its pages and spills them
        together before it returns)."""
        if self._spill_batch is not None:
            self._spill_batch.append((page, chain_tokens))
        elif self.offload is not None:
            self._spill([(page, chain_tokens)], "evict")

    def _spill(self, chains: list[tuple[int, list[int]]], trigger: str) -> None:
        """Enqueue the device->host copies of ``(page, token chain)`` pairs
        whose chain is page-aligned (``OffloadManager.spill``), on every
        rank of a mesh: the chains stay with the leader."""
        P = self.cfg.page_size
        good = [(page, tuple(chain)) for page, chain in chains
                if chain and len(chain) % P == 0]
        if good:
            self._device("spill", [p for p, _ in good], trigger,
                         data=[c for _, c in good])

    @_locked
    def offload_flush(self) -> int:
        """Land every pending device->host page copy in the host pool (the
        scheduler's idle ticks; admission lands what it needs itself).
        Returns pages landed."""
        if self.offload is None:
            return 0
        return self.offload.flush()

    def prefix_digests(self, cap: int | None = None) -> list[str]:
        """This replica's cached state for a fleet registry: the hex chain
        keys (``offload.chain_key_hex``) of every trie-resident page chain
        and every host-pool page, at most ``cap`` (argument, else
        ``OPSAGENT_FLEET_DIGEST_CAP``, else 4096; the newest kept).
        ``digests_truncated`` says whether the cap clipped them."""
        if cap is None:
            try:
                cap = int(os.environ.get("OPSAGENT_FLEET_DIGEST_CAP", ""))
            except ValueError:
                cap = 0
            if cap <= 0:
                cap = 4096
        with self.lock:
            keys = [chain_key_hex(c) for c in self.alloc.trie_chains()]
        if self.offload is not None:
            keys.extend(self.offload.pool.digests())
        self._digests_truncated = len(keys) > cap
        if self._digests_truncated:
            keys = keys[-cap:]
        return keys

    def digests_truncated(self) -> bool:
        """Whether the last ``prefix_digests`` was clipped by its cap."""
        return self._digests_truncated

    def fault_in_prefix(self, prompt_ids: list[int], request_id: str = "") -> int:
        """Fleet-global KV fault-in: when the usable prefix of
        ``prompt_ids`` misses the HBM trie and the host pool, ask the fleet
        page directory who owns the missing chain and fetch it from that
        peer into the host pool (``fleet/pagestore.py``), where the
        admission's host restore lands it. Probes under the engine lock,
        fetches outside it. Returns pages landed; 0 on a miss or any
        failure, never raises. ``request_id`` tags the fault-in's flight
        events with the journey of the admission."""
        if self.pagestore is None or self.offload is None:
            return 0
        try:
            usable = prompt_ids[: len(prompt_ids) - 1]
            total = len(usable) // self.cfg.page_size
            if total == 0:
                return 0
            with self.lock:
                self.offload.flush()
                matched = len(self.alloc.match_prefix(usable))
            covered = self.offload.pool.coverage(usable, start_page=matched)
            if matched + covered >= total:
                return 0  # the local tiers cover it
            return self.pagestore.fault_in(usable, start_page=matched + covered,
                                           request_id=request_id)
        except Exception:  # noqa: BLE001 - never raises into admission
            log.exception("page fault-in probe failed; re-prefilling")
            return 0

    @_locked
    def replicate_chain(self, token_ids: list[int]) -> int:
        """Copy this token chain's trie-resident pages into the host pool
        without evicting them (a peer can then be sent the chain while
        local sessions keep decoding on it; ``park_chain`` frees them).
        Returns pages newly copied."""
        if self.offload is None:
            return 0
        self.offload.flush()
        pages = self.alloc.match_prefix(token_ids)
        if not pages:
            return 0
        P = self.cfg.page_size
        have = set(self.offload.pool.digests())
        chains = [(pg, token_ids[: (i + 1) * P]) for i, pg in enumerate(pages)
                  if chain_key_hex(token_ids[: (i + 1) * P]) not in have]
        if not chains:
            return 0
        self._spill(chains, "replicate")
        return self.offload.flush()

    @_locked
    def park_chain(self, token_ids: list[int]) -> int:
        """Tool-time parking: free the HBM pages holding this token
        history's KV (the session's trie-resident state) after copying
        them to the host pool, while the session's ReAct loop blocks on a
        tool. Returns tokens parked (0 with the tier off or nothing
        evictable)."""
        if self.offload is None:
            return 0
        pages = self.alloc.match_prefix(token_ids)
        if not pages:
            return 0
        self._spill_batch = []
        try:
            n = self.alloc.evict_chain(pages)
        finally:
            batch, self._spill_batch = self._spill_batch, None
        # Nothing is enqueued between the evictions and this gather.
        self._spill(batch, "tool")
        if n:
            obs.OFFLOAD_PARKS.inc(trigger="tool")
            obs.flight.record("park", trigger="tool", pages=n,
                              tokens=n * self.cfg.page_size)
            self._observe_occupancy()
        return n * self.cfg.page_size

    @_locked
    def park_sequence(self, seq_id: int) -> Sequence | None:
        """Pressure parking: copy a live sequence's written pages to the
        host pool and free all its HBM state. The scheduler re-queues the
        request with the generated tokens folded into its prompt, and the
        re-admission restores the pages instead of re-prefilling them.
        Returns the parked Sequence, or None when it finished while the
        pipelines settled (the caller reaps it)."""
        if self.offload is None:
            raise RuntimeError("park_sequence requires the offload tier")
        # Settle the async ticks and the pipelined blocks first: they may
        # still append tokens to this sequence, and their pulls roll page
        # bookings back to what was written.
        self._async_settle()
        while self._inflight or self._lane_of:
            try:
                self._flush_and_invalidate()
            except Exception:  # noqa: BLE001 - the row's own failure
                log.exception("stream callback raised while settling for parking")
        seq = self.sequences.get(seq_id)
        if seq is None or seq.done or seq_id in self._prefilling:
            return None
        del self.sequences[seq_id]
        self._ffwd_noted.discard(seq_id)
        written = seq.prompt_ids + seq.tokens[:-1]
        P = self.cfg.page_size
        pages = self.alloc.pages_of(seq_id)
        chains = [(pages[i], written[: (i + 1) * P])
                  for i in range(min(len(written) // P, len(pages)))]
        self._spill(chains, "pressure")
        # A plain free, no trie donation: the content lives in the host
        # tier now, and an HBM copy would defeat the parking.
        self.alloc.free(seq_id)
        obs.OFFLOAD_PARKS.inc(trigger="pressure")
        obs.flight.record("park", trigger="pressure", seq_id=seq_id, pages=len(chains),
                          tokens=len(chains) * P, generated=len(seq.tokens))
        if seq.decode_span is not None:
            obs.attribution.record_goodput(seq.decode_span.duration_s(), "decode_active")
            seq.decode_span.close(tokens=len(seq.tokens), finish_reason="parked")
            seq.decode_span = None
        self._observe_occupancy()
        return seq

    # -- observability -------------------------------------------------------
    def _observe_occupancy(self) -> None:
        """Refresh the engine gauges (KV page utilization, batch
        occupancy) and delta-sync the allocator's cumulative prefix-trie
        eviction count into the obs counter. Host arithmetic, under the
        engine lock: admission, ticks, blocks, finish and each scrape."""
        free = self.alloc.free_pages
        obs.KV_PAGES_FREE.set(free)
        obs.KV_PAGE_UTILIZATION.set(1.0 - free / max(1, self.alloc.num_pages))
        running = sum(1 for s in self.sequences.values() if not s.done)
        obs.BATCH_OCCUPANCY.set(running / max(1, self.cfg.max_batch_size))
        obs.RUNNING_SEQUENCES.set(len(self.sequences))
        ev = self.alloc.evictions
        if ev > self._evictions_seen:
            obs.PREFIX_EVICTIONS.inc(ev - self._evictions_seen)
            obs.flight.record("prefix_eviction", count=ev - self._evictions_seen)
            self._evictions_seen = ev

    def _first_token_obs(self, seq: Sequence) -> None:
        """The prompt is done and its first token sampled: observe TTFT
        (admission to first token), record the prefill span and open the
        request's decode span (one child per tick or block; closed when the
        sequence finishes). A TTFT past the SLO line is a flight anomaly."""
        obs.TTFT_SECONDS.observe(seq.ttft_s)
        cls = obs.trace.class_of(seq.trace)
        if cls:
            obs.CLASS_TTFT_SECONDS.observe(seq.ttft_s, **{"class": cls})
        obs.attribution.record_goodput(seq.ttft_s, "prefill", slo_class=cls)
        ttft_ms = round(seq.ttft_s * 1e3, 3)
        rid = obs.flight.request_id_of(seq.trace)
        obs.flight.record("ttft", seq_id=seq.seq_id, ttft_ms=ttft_ms, request_id=rid)
        thr = obs.flight.ttft_threshold_s()
        if thr > 0 and seq.ttft_s > thr:
            obs.flight.anomaly(
                "ttft_breach", seq_id=seq.seq_id, ttft_ms=ttft_ms,
                threshold_ms=round(thr * 1e3, 3), request_id=rid,
            )
        if seq.trace is not None:
            seq.trace.child("prefill", seq.started_s, time.perf_counter(),
                            prompt_tokens=seq.prompt_len)
            seq.decode_span = seq.trace.start_child("decode")

    def _preempted(self, seq: Sequence) -> None:
        """A sequence force-finished because the page pool ran dry."""
        obs.PREEMPTIONS.inc()
        obs.flight.record("preemption", seq_id=seq.seq_id)
        log.warning("seq %d truncated: KV page budget exhausted", seq.seq_id)

    def mixed_gap_break(self) -> None:
        """The scheduler went idle: the next mixed tick's host gap starts
        no earlier than now's idle wait."""
        self._mixed_gap_stamp = None

    def generate(
        self,
        prompts: list[list[int]],
        sampling: SamplingParams | None = None,
        mask_fn: list[MaskFn | None] | None = None,
        stream: list[Callable[[int], None] | None] | None = None,
    ) -> list[list[int]]:
        """Synchronous batch generation: admit every prompt, then block
        decode until all are done. ``mask_fn`` and ``stream`` give each
        prompt its own (a ``JsonConstraint`` follows one sequence)."""
        none = [None] * len(prompts)
        ids = [
            self.add_request(p, sampling, m, f)
            for p, m, f in zip(prompts, mask_fn or none, stream or none)
        ]
        pending = {i for i in ids if not self.sequences[i].done}
        while pending:
            self.step_block(sorted(pending))
            pending = {i for i in pending if not self.sequences[i].done}
        self.drain()
        return [self.finish(i) for i in ids]
