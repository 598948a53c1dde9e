"""Single-process serving engine over the paged KV cache (the port's
counterpart of ``opsagent_tpu/serving/engine.py``).

Synchronous: every method returns with its device work done and its tokens
on the host. Two device programs carry the traffic:

- ``step_mixed``: one forward over decode lanes (one token each) and
  prefill chunks together, through the ragged paged-attention kernel;
- ``step_block``: up to ``decode_block`` decode + sample steps with the loop
  state on the device and one host pull, through the decode kernel.

On the card with the kernels each decode step and each mixed tick is one
CUDA graph replay (``serving.decode_graph``), captured by ``warmup``.

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

``EngineConfig.quantize`` and ``kv_quantize`` select int8/int4 weights
(every projection through the quantized matmul kernel) and int8 KV pages
(the attention kernels' int8 instances); ``paged_backend`` picks the
paged-attention kernels ("dma" or "grid"); ``attn_impl`` picks kernels or
plain versions for all of them at once. ``checkpoint`` loads an HF
safetensors directory instead of random weights.

No async runtime, pipelining, grammar fast-forward, speculation, offload
or snapshots in this port yet.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field, replace
from functools import partial
from typing import Callable

import numpy as np
import torch

from ..device import resolve_device
from ..models.config import ModelConfig, resolve_model
from ..models.llama import Llama
from ..models.loader import load_checkpoint
from ..ops.paged_attention import PAGED_BACKENDS
from .constrained import NATIVE_TABLE_BUDGET, JsonConstraint, TokenFSM, device_table_fsm
from .decode_graph import StepGraph
from .decode_loop import (
    DecodeState,
    FsmTables,
    MixedState,
    decode_block,
    decode_step_body,
    mixed_step_body,
)
from .kvcache import InvalidRequest, OutOfPages, PageAllocator
from .sampler import SamplingParams
from .tokenizer import ByteTokenizer, Tokenizer

log = logging.getLogger("opsagent_tpu_torch.engine")

# A constrained-decoding mask: the generated tokens -> [vocab] bool allowed.
MaskFn = Callable[[list[int]], np.ndarray]


@dataclass
class EngineConfig:
    # A preset name, or "auto" for the checkpoint's own config.json.
    model: str = "tiny-test"
    # HF safetensors directory; "" = random weights from ``seed``.
    checkpoint: str = ""
    dtype: torch.dtype = torch.bfloat16
    page_size: int = 16
    num_pages: int = 2048
    max_pages_per_seq: int = 320   # 5120 tokens
    max_batch_size: int = 8
    # Decode steps per step_block call: one host pull per block.
    decode_block: int = 32
    # Query-axis buckets of the mixed step: a chunk pads to the smallest
    # bucket holding it; the largest caps a chunk.
    mixed_buckets: tuple[int, ...] = (16, 32, 64, 128)
    # Per-mixed-step token budget: decode lanes first, then prefill chunks.
    max_step_tokens: int = 256
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
    # and sampled) and each mixed bucket's forward + sample as CUDA graphs
    # (``warmup``, or the first step that needs them) and replays them;
    # False runs the same steps eagerly through the same kernels, the
    # reference a replay is checked against. The plain path and the CPU
    # always run them eagerly.
    cuda_graphs: bool = True


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


class Engine:
    def __init__(
        self,
        cfg: EngineConfig,
        model_cfg: ModelConfig | None = None,
        model: Llama | None = None,
        tokenizer: Tokenizer | None = None,
    ):
        """``model``: a ready ``Llama`` on the engine's device (tests and
        the reference engine share one); otherwise the weights of
        ``cfg.checkpoint`` or, without one, random weights from ``cfg.seed``
        are built on the device."""
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.model_cfg = model_cfg or (
            model.cfg if model is not None
            else resolve_model(cfg.model, cfg.checkpoint)
        )
        if cfg.paged_backend not in PAGED_BACKENDS:
            raise ValueError(
                f"paged_backend={cfg.paged_backend!r}: expected one of "
                f"{sorted(PAGED_BACKENDS)}"
            )
        impl = cfg.attn_impl or ("plain" if self.device.type == "cpu" else "cuda")
        if impl not in ("cuda", "plain"):
            raise ValueError(f"attn_impl={impl!r}: expected 'cuda' or 'plain'")
        if impl == "cuda" and self.device.type != "cuda":
            raise ValueError("attn_impl='cuda' needs a CUDA device")
        self.attn_impl = impl
        # Llama and PagedKVCache validate quantize and kv_quantize.
        if model is not None and model.quantize != cfg.quantize:
            raise ValueError(
                f"quantize={cfg.quantize!r} but the given model holds "
                f"{model.quantize or 'unquantized'!r} weights"
            )
        self.tokenizer = tokenizer or ByteTokenizer(self.model_cfg.vocab_size)
        with torch.inference_mode():
            self.model = model if model is not None else self._build_model()
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
        self._fsm_loaded: TokenFSM | None = None
        self._host_rows = False     # host_mask holds a hosted row's mask
        # ("decode", greedy) and ("mixed", bucket) -> graph, made by warmup.
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
        self.sequences: dict[int, Sequence] = {}
        self._prefilling: dict[int, int] = {}   # seq_id -> prompt tokens done
        self._generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 1
        )

    def _build_model(self) -> Llama:
        """Random weights from the seed, built on the device; or the
        checkpoint's, read (and quantized) on the host, then copied into a
        model built on the device, so the device never holds two copies."""
        cfg = self.cfg
        if not cfg.checkpoint:
            return Llama(self.model_cfg, cfg.dtype, self.device, seed=cfg.seed,
                         quantize=cfg.quantize)
        state = load_checkpoint(cfg.checkpoint, self.model_cfg, cfg.dtype,
                                device="cpu", quantize=cfg.quantize)
        model = Llama(self.model_cfg, cfg.dtype, self.device, seed=None,
                      quantize=cfg.quantize)
        model.load_state_dict(state)
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
    def add_request(
        self,
        prompt_ids: list[int],
        sampling: SamplingParams | None = None,
        mask_fn: MaskFn | None = None,
        stream: Callable[[int], None] | None = None,
    ) -> int:
        """Admit a request and prefill it whole (mixed steps with no decode
        lanes), sampling its first token. Returns the sequence id; raises
        OutOfPages when the page pool is full."""
        seq_id = self.begin_request(prompt_ids, sampling, mask_fn, stream)
        while seq_id in self._prefilling:
            self.step_mixed([], {seq_id: self.cfg.mixed_buckets[-1]})
        return seq_id

    def begin_request(
        self,
        prompt_ids: list[int],
        sampling: SamplingParams | None = None,
        mask_fn: MaskFn | None = None,
        stream: Callable[[int], None] | None = None,
    ) -> int:
        """Stage 1 of admission: allocate pages, reusing cached prefix pages,
        and register the sequence as prefilling. No device work: mixed steps
        then run its prompt in chunks. ``mask_fn`` constrains the sequence's
        tokens (a mask that raises on the empty prefix is an invalid
        request); ``stream`` receives each accepted token."""
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
        # Reuse full pages of the prompt minus its last token: at least one
        # token must run through the model to produce the next logits.
        prefix_pages = self.alloc.match_prefix(prompt_ids[: n - 1])
        matched = len(prefix_pages) * self.cfg.page_size
        seq_id = self.alloc.allocate(n, prefix_pages=prefix_pages)
        self.sequences[seq_id] = Sequence(
            seq_id, n, prompt_ids=list(prompt_ids), params=sampling,
            mask_fn=mask_fn, on_token=stream,
        )
        self._prefilling[seq_id] = matched
        return seq_id

    def prefill_progress(self, seq_id: int) -> tuple[int, int]:
        """(prompt tokens already in cache, prompt length)."""
        return self._prefilling[seq_id], self.sequences[seq_id].prompt_len

    def _drop_admission(self, seq_id: int) -> None:
        self.sequences.pop(seq_id, None)
        self._prefilling.pop(seq_id, None)
        self.alloc.free(seq_id)

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
        if seq.on_token is not None:
            try:
                seq.on_token(token)
            except Exception:  # noqa: BLE001 - ends this row, not the step
                log.exception("stream callback of sequence %d failed", seq.seq_id)
                seq.done, seq.finish_reason = True, "error"
                return
        if token == self.tokenizer.eos_id:
            seq.done, seq.finish_reason = True, "stop"
        elif len(seq.tokens) >= seq.params.max_tokens:
            seq.done, seq.finish_reason = True, "length"
        elif seq.params.stop and self._hit_stop_string(seq):
            seq.done, seq.finish_reason = True, "stop"

    def _hit_stop_string(self, seq: Sequence) -> bool:
        """Check the decoded tail for a stop string (a char may span up to 4
        byte tokens, so the window is sized in tokens)."""
        longest = max(len(s) for s in seq.params.stop)
        tail = self.tokenizer.decode(seq.tokens[-(longest * 4 + 8):])
        return any(s in tail for s in seq.params.stop)

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
        if mask.shape[0] > self._fsm.rows and not self._replays():
            self._fsm = FsmTables.empty(
                self.cfg.max_batch_size, self.model_cfg.vocab_size, mask.shape[0],
                self.device,
            )
            self._host_rows = False
        with torch.inference_mode():
            self._fsm.load(mask, dest)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
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
        self._fsm.host_mask.copy_(torch.from_numpy(hm))
        self._host_rows = bool(masks)

    def _fsm_row(self, s: Sequence, on_device: bool) -> int:
        """The row's FsmTables row: its DFA state + 1 on the device tables,
        else 0 (unconstrained or hosted)."""
        return s.mask_fn.dfa_state(s.tokens) + 1 if on_device else 0

    # -- mixed prefill + decode step ----------------------------------------
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
        False (more chunks to go)."""
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
        try:
            with torch.inference_mode():
                if self._replays():
                    step = self._prepare()[("mixed", S)].replay
                    self.mixed_replays += 1
                else:
                    step = self._mixed_body(S, self._generator)
                    self.mixed_eager_ticks += 1
                self._load_host_masks(masks)
                state = self._mixed[S]
                state.load(tokens, starts, qlens, tables, temps, top_k, top_p, fsm, emits)
                # Every row samples; rows whose chunk does not finish the
                # prompt discard their token below.
                step()
                sampled = state.out.cpu().numpy()
        except Exception:
            # Undo the decode rows' bookings (tokens never written) and drop
            # the chunk admissions before the failure propagates.
            for s in decode:
                if not s.done:
                    self.alloc.truncate(s.seq_id, self.alloc.length(s.seq_id) - 1)
            for sid, *_ in chunks:
                self._drop_admission(sid)
            raise
        for i, s in enumerate(decode):
            self._accept_token(s, int(sampled[i]))
            decode_out[s.seq_id] = [int(sampled[i])]
        for j, (sid, seq, done, c) in enumerate(chunks):
            prefill_out[sid] = done + c >= seq.prompt_len
            if not prefill_out[sid]:
                self._prefilling[sid] = done + c
                continue
            del self._prefilling[sid]
            if not seq.done:  # a failed mask ended it already
                self._accept_token(seq, int(sampled[base + j]))
        return decode_out, prefill_out

    # -- block decode --------------------------------------------------------
    def step_block(self, seq_ids: list[int] | None = None) -> dict[int, list[int]]:
        """Advance running sequences by up to ``cfg.decode_block`` tokens in
        one device-resident loop with one host pull; hosted constrained
        rows advance one token first, in a one-step block of their own.
        Returns {seq_id: accepted tokens}."""
        running = [
            s for s in self.sequences.values()
            if not s.done and s.seq_id not in self._prefilling
        ] if seq_ids is None else [
            self.sequences[i] for i in seq_ids if not self.sequences[i].done
        ]
        running = running[:self.cfg.max_batch_size]
        routes = self._fsm_routes(running)
        hosted = [s for s in running if routes.get(s.seq_id) is False]
        rest = [s for s in running if routes.get(s.seq_id) is not False]
        out: dict[int, list[int]] = {}
        if hosted:
            out.update(self._decode_rows(hosted, 1, routes))
        if rest:
            out.update(self._decode_rows(rest, self.cfg.decode_block, routes))
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
        n_steps = int(budgets.max())
        with torch.inference_mode():
            if self._replays():
                step = self._prepare()[("decode", greedy)].replay
                self.decode_replays += n_steps
            else:
                step = self._decode_body(greedy, self._generator)
                self.decode_eager_steps += n_steps
            self.hosted_steps += len(masks) * n_steps
            self._load_host_masks(masks)
            toks = decode_block(
                self._decode, step, tokens, write_at, active, budgets, table,
                temps, top_k, top_p, n_steps=n_steps, fsm=fsm,
            ).cpu().numpy()
        out: dict[int, list[int]] = {}
        for i, s in enumerate(lanes):
            if s is None:
                continue
            n0 = len(s.tokens)
            for j in range(int(budgets[i])):
                self._accept_token(s, int(toks[i, j]))
                if s.done:
                    break
            out[s.seq_id] = s.tokens[n0:]
            if s.done:
                # Roll the block's booking back to what was written.
                self.alloc.truncate(s.seq_id, self._host_written(s))
        return out

    # -- warmup and the step graphs -------------------------------------------
    def warmup(self) -> float:
        """Prepare the serving programs before the first request (the
        counterpart of the JAX engine's ``warmup``): builds the kernels and
        runs each step body eagerly twice (the decode step greedy and
        sampled, the mixed tick at every bucket) over an all -1 page table
        with every row inactive, so that each kernel instance's one-time
        set-up and the split calls' workspaces happen outside a capture;
        then, on the card with the kernels, captures each body as a CUDA
        graph. The warm steps write only the cache's scratch slot and draw
        from a spare generator: the cache's pages, the allocator and the
        engine's generator are untouched. Call it before other threads
        touch CUDA (a capture is process-wide). Returns wall seconds
        spent."""
        t0 = time.perf_counter()
        with torch.inference_mode():
            self._prepare()
        return time.perf_counter() - t0

    def _replays(self) -> bool:
        return self.attn_impl == "cuda" and self.cfg.cuda_graphs

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
        for greedy in (True, False):
            for _ in range(2):
                decode_block(
                    self._decode, self._decode_body(greedy, spare), idle, idle,
                    idle.astype(bool), idle, table, *sampling, n_steps=1,
                )
            bodies["decode", greedy] = (
                self._decode, self._decode_body(greedy, self._generator)
            )
        for S, state in self._mixed.items():
            state.load(np.zeros((B, S), np.int64), idle, idle, table, *sampling)
            for _ in range(2):
                self._mixed_body(S, spare)()
            bodies["mixed", S] = (state, self._mixed_body(S, self._generator))
        if self._replays():
            for key, (state, body) in bodies.items():
                # The greedy decode step draws no random numbers.
                gen = None if key == ("decode", True) else self._generator
                self._graphs[key] = StepGraph(body, (state, self._fsm), self.cache, gen)
            torch.cuda.synchronize(self.device)
        self._warm = True
        return self._graphs

    def _decode_body(self, greedy: bool, generator: torch.Generator):
        """The block's step, eager: ``decode_step_body`` over the engine's
        state, constraint tables and cache."""
        return partial(
            decode_step_body, self.model, self._decode, self.cache, generator,
            self.tokenizer.eos_id, self.tokenizer.pad_id, greedy,
            self.attn_impl == "plain", self.cfg.paged_backend, tables=self._fsm,
        )

    def _mixed_body(self, S: int, generator: torch.Generator):
        """The mixed tick at bucket ``S``, eager: ``mixed_step_body`` over
        that bucket's state, the constraint tables and the engine's cache."""
        return partial(
            mixed_step_body, self.model, self._mixed[S], self.cache, generator,
            self.attn_impl == "plain", self.cfg.paged_backend, tables=self._fsm,
        )

    def finish(self, seq_id: int) -> list[int]:
        """Release a sequence; returns its generated tokens. Full pages go
        to the prefix trie keyed by the tokens they hold (the prompt and all
        generated tokens but the last, which was never written)."""
        seq = self.sequences.pop(seq_id)
        self.alloc.free(seq_id, tokens=seq.prompt_ids + seq.tokens[:-1])
        return seq.tokens

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
        return [self.finish(i) for i in ids]
