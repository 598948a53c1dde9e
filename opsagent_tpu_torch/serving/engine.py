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

``EngineConfig.quantize`` and ``kv_quantize`` select int8/int4 weights
(every projection through the quantized matmul kernel) and int8 KV pages
(the attention kernels' int8 instances); ``paged_backend`` picks the
paged-attention kernels ("dma" or "grid"); ``attn_impl`` picks kernels or
plain versions for all of them at once. ``checkpoint`` loads an HF
safetensors directory instead of random weights.

No async runtime, pipelining, grammar fast-forward, speculation, offload,
snapshots or constrained decoding in this port yet.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from functools import partial

import numpy as np
import torch

from ..device import resolve_device
from ..models.config import ModelConfig, resolve_model
from ..models.llama import Llama
from ..models.loader import load_checkpoint
from ..ops.paged_attention import PAGED_BACKENDS
from .decode_graph import StepGraph
from .decode_loop import (
    DecodeState,
    MixedState,
    decode_block,
    decode_step_body,
    mixed_step_body,
)
from .kvcache import InvalidRequest, OutOfPages, PageAllocator
from .sampler import SamplingParams
from .tokenizer import ByteTokenizer, Tokenizer


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
    done: bool = False
    finish_reason: str = ""        # "stop" | "length"


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
        # ("decode", greedy) and ("mixed", bucket) -> graph, made by warmup.
        self._graphs: dict[tuple[str, object], StepGraph] = {}
        self._warm = False
        # Decode steps and mixed ticks run by graph replay and eagerly.
        self.decode_replays = self.decode_eager_steps = 0
        self.mixed_replays = self.mixed_eager_ticks = 0
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
        self, prompt_ids: list[int], sampling: SamplingParams | None = None
    ) -> int:
        """Admit a request and prefill it whole (mixed steps with no decode
        lanes), sampling its first token. Returns the sequence id; raises
        OutOfPages when the page pool is full."""
        seq_id = self.begin_request(prompt_ids, sampling)
        while seq_id in self._prefilling:
            self.step_mixed([], {seq_id: self.cfg.mixed_buckets[-1]})
        return seq_id

    def begin_request(
        self, prompt_ids: list[int], sampling: SamplingParams | None = None
    ) -> int:
        """Stage 1 of admission: allocate pages, reusing cached prefix pages,
        and register the sequence as prefilling. No device work: mixed steps
        then run its prompt in chunks."""
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
        if n + sampling.max_tokens > window:
            from dataclasses import replace

            sampling = replace(sampling, max_tokens=window - n)
        # Reuse full pages of the prompt minus its last token: at least one
        # token must run through the model to produce the next logits.
        prefix_pages = self.alloc.match_prefix(prompt_ids[: n - 1])
        matched = len(prefix_pages) * self.cfg.page_size
        seq_id = self.alloc.allocate(n, prefix_pages=prefix_pages)
        self.sequences[seq_id] = Sequence(
            seq_id, n, prompt_ids=list(prompt_ids), params=sampling
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

    # -- mixed prefill + decode step ----------------------------------------
    def step_mixed(
        self, decode_ids: list[int], prefill_chunks: dict[int, int]
    ) -> tuple[dict[int, list[int]], dict[int, bool]]:
        """ONE forward that advances every given decode lane by a token and
        runs one prefill chunk for each admitting sequence in
        ``prefill_chunks`` ({seq_id: chunk tokens}). Chunk rows pad to the
        smallest mixed bucket holding the largest chunk; decode rows ride at
        q_len 1.

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
        chunks: list[tuple[int, Sequence, int, int]] = []
        smax = 1
        for sid, want in prefill_chunks.items():
            seq, done = self.sequences[sid], self._prefilling[sid]
            c = min(want, self.cfg.mixed_buckets[-1], seq.prompt_len - done)
            chunks.append((sid, seq, done, c))
            smax = max(smax, c)
        S = self._mixed_bucket(smax)
        tokens = np.full((B, S), self.tokenizer.pad_id, np.int64)
        starts = np.zeros((B,), np.int32)
        qlens = np.zeros((B,), np.int32)
        tables = np.full((B, self.cfg.max_pages_per_seq), -1, np.int32)
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
        temps, top_k, top_p = self._sampling_arrays(slots, B)
        try:
            with torch.inference_mode():
                if self._replays():
                    step = self._prepare()[("mixed", S)].replay
                    self.mixed_replays += 1
                else:
                    step = self._mixed_body(S, self._generator)
                    self.mixed_eager_ticks += 1
                state = self._mixed[S]
                state.load(tokens, starts, qlens, tables, temps, top_k, top_p)
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
            self._accept_token(seq, int(sampled[base + j]))
        return decode_out, prefill_out

    # -- block decode --------------------------------------------------------
    def step_block(self, seq_ids: list[int] | None = None) -> dict[int, list[int]]:
        """Advance running sequences by up to ``cfg.decode_block`` tokens in
        one device-resident loop with one host pull. Returns {seq_id:
        accepted tokens}."""
        running = [
            s for s in self.sequences.values()
            if not s.done and s.seq_id not in self._prefilling
        ] if seq_ids is None else [
            self.sequences[i] for i in seq_ids if not self.sequences[i].done
        ]
        B = self.cfg.max_batch_size
        running = running[:B]
        tokens = np.zeros((B,), np.int64)
        write_at = np.zeros((B,), np.int32)
        budgets = np.zeros((B,), np.int32)
        lanes: list[Sequence | None] = [None] * B
        for i, s in enumerate(running):
            want = min(self.cfg.decode_block, s.params.max_tokens - len(s.tokens))
            got = self.alloc.extend_upto(s.seq_id, want) if want > 0 else 0
            if got == 0:
                s.done, s.finish_reason = True, "length"
                self.alloc.truncate(s.seq_id, self._host_written(s))
                continue
            lanes[i] = s
            tokens[i] = s.tokens[-1] if s.tokens else self.tokenizer.bos_id
            write_at[i] = self._host_written(s)
            budgets[i] = got
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
            toks = decode_block(
                self._decode, step, tokens, write_at, active, budgets, table,
                temps, top_k, top_p, n_steps=n_steps,
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
                self._graphs[key] = StepGraph(body, state, self.cache, gen)
            torch.cuda.synchronize(self.device)
        self._warm = True
        return self._graphs

    def _decode_body(self, greedy: bool, generator: torch.Generator):
        """The block's step, eager: ``decode_step_body`` over the engine's
        state and cache."""
        return partial(
            decode_step_body, self.model, self._decode, self.cache, generator,
            self.tokenizer.eos_id, self.tokenizer.pad_id, greedy,
            self.attn_impl == "plain", self.cfg.paged_backend,
        )

    def _mixed_body(self, S: int, generator: torch.Generator):
        """The mixed tick at bucket ``S``, eager: ``mixed_step_body`` over
        that bucket's state and the engine's cache."""
        return partial(
            mixed_step_body, self.model, self._mixed[S], self.cache, generator,
            self.attn_impl == "plain", self.cfg.paged_backend,
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
    ) -> list[list[int]]:
        """Synchronous batch generation: admit every prompt, then block
        decode until all are done."""
        ids = [self.add_request(p, sampling) for p in prompts]
        pending = {i for i in ids if not self.sequences[i].done}
        while pending:
            self.step_block(sorted(pending))
            pending = {i for i in pending if not self.sequences[i].done}
        return [self.finish(i) for i in ids]
