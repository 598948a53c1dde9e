"""Device-resident block decode: forward + sample with the loop state on the
card (the port's counterpart of ``opsagent_tpu/serving/decode_loop.py``'s
``decode_block``).

A block is up to ``n_steps`` decode + sample steps. Each row's last token,
write offset and EOS flag stay on the device between steps, and a row goes
inactive on the device when it samples EOS or spends its budget: inactive
rows stop writing KV and emit pad. The host pulls the block's
``[B, n_steps]`` tokens once, at the end, and runs the stop-string checks.

Two parts:

- ``decode_step_body``: one decode + sample + state-update step that reads
  and writes only the tensors of a ``DecodeState``, in place, and
  allocates nothing the next step reads. ``serving.decode_graph`` captures
  it as a CUDA graph, the counterpart of JAX's one XLA program per block;
  the plain path and the CPU run it eagerly, so the code that is captured
  is the code the CPU tests run;
- ``decode_block``: the driver. It copies the host's inputs into the
  state, runs a step (the body, or a graph's replay) ``n_steps`` times and
  returns the block's tokens.

``mixed_step_body`` does the same for one mixed tick's forward + sample
over a ``MixedState``, one per query-axis bucket (JAX's mixed programs, one
per bucket); its sampling tail, ``pick_rows``, also picks the first token of
a split-lane prefill chunk (``Engine.prefill_batch``).

``speculative_step_body`` is the greedy block's speculative iteration
(JAX's ``speculative_block_carry`` scan body): prompt-lookup drafts
(``ngram_draft``) verified in one ``Llama.verify_step``, 1 to k + 1 tokens
a row, over a ``SpecState`` beside the ``DecodeState`` whose carry it
shares; ``speculative_block`` drives it as ``decode_block`` drives the
decode step.

``record_dispatch`` and ``record_mixed_dispatch`` are the host-side
telemetry of one block call and one mixed tick (JAX's names): the engine
calls them around the drivers, never inside a body.

Constrained decoding runs inside both bodies (JAX's ``decode_block_carry``
and ``mixed_step_carry``): each row's ``fsm`` indexes the loaded schema's
``FsmTables``, whose row 0 allows everything, and a ``host_mask`` row
carries a mask the host computed. Every row's logits are masked by both
before it picks, and the rows that emit advance their ``fsm`` through the
destination table on the device. Unconstrained rows sit at row 0 with an
all-true host row, so the same bodies, and the same graphs, serve every
kind of row.

Given ``extras``, both bodies also run the OpenAI sampler extras (JAX's
``_bias_array`` and ``_decode_sample_lp``): each row's logits are adjusted
by its static ``logit_bias`` row minus its presence and frequency
penalties over the tokens it emitted (``SamplingExtras``, counted on the
device), and the logprob of the token picked and the top 20 come from
those adjusted logits before the constraint mask. A row that asks for
none of them holds zeros, and its logits are bit-equal to the unadjusted
ones. The engine captures each body with and without them: a step with
no such row replays the graph without.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Callable

import numpy as np
import torch

from ..models.llama import Llama, PagedKVCache
from .sampler import NEG_INF, sample


class StaticBuffers:
    """Device buffers that a captured step reads and writes. Nothing
    rebinds a buffer once it is made: a captured step reads the addresses
    that its capture saw, so ``load`` copies into them."""

    def buffers(self) -> tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f.name) for f in fields(self))

    def _copy_in(self, pairs) -> None:
        """Copy host arrays into the buffers, in stream order. On the card
        each array is staged in pinned memory and copied without blocking
        the host: a copy from pageable memory would wait for the stream to
        drain, and so for every step already enqueued (the pipelined
        blocks and async ticks enqueue ahead). The caching host allocator
        keeps a staging buffer until its copy has run."""
        for buf, a in pairs:
            src = torch.from_numpy(np.ascontiguousarray(a))
            if buf.is_cuda:
                buf.copy_(src.pin_memory(), non_blocking=True)
            else:
                buf.copy_(src)

    def _staged(self, a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
        """A host array as a tensor on ``like``'s device, copied as
        ``_copy_in`` copies."""
        buf = torch.empty(a.shape, dtype=like.dtype, device=like.device)
        self._copy_in(((buf, a),))
        return buf


def to_host(t: torch.Tensor) -> tuple[torch.Tensor, torch.cuda.Event | None]:
    """Start copying ``t`` to the host: (host tensor, event). On the card
    the copy goes into pinned memory without blocking the host, and the
    event, recorded after it, says when the host tensor holds the values;
    it is a copy, so later steps may overwrite ``t``. On the CPU the copy
    is made at once and the event is None."""
    if not t.is_cuda:
        return t.clone(), None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def from_host(host: torch.Tensor, event: torch.cuda.Event | None) -> np.ndarray:
    """Wait for ``to_host``'s copy (its event alone, not the device) and
    return the values."""
    if event is not None:
        event.synchronize()
    return host.numpy()


@dataclass
class FsmTables(StaticBuffers):
    """The loaded constraint's device tables (``TokenFSM.dense_tables``
    numbering: row 0 is the FREE sentinel, DFA state s is row s + 1) and the
    host-computed masks, shared by the decode step and every mixed bucket."""

    mask: torch.Tensor        # [R, V] bool allowed tokens per row
    dest: torch.Tensor        # [R, V] int32 row after each allowed token
    host_mask: torch.Tensor   # [B, V] bool per batch row; all true when unused

    @classmethod
    def empty(cls, batch: int, vocab: int, rows: int, device: torch.device) -> FsmTables:
        """``rows`` capacity, nothing loaded: row 0 allows everything."""
        mask = torch.zeros((rows, vocab), dtype=torch.bool, device=device)
        mask[0] = True
        return cls(
            mask=mask, dest=torch.zeros((rows, vocab), dtype=torch.int32, device=device),
            host_mask=torch.ones((batch, vocab), dtype=torch.bool, device=device),
        )

    @property
    def rows(self) -> int:
        return self.mask.shape[0]

    def load(self, mask: np.ndarray, dest: np.ndarray) -> None:
        """Copy one FSM's [S+1, Vt] tables into the first S + 1 rows. Ids
        past the tokenizer's Vt (a model's padded vocab) are forbidden on
        constrained rows; row 0 stays all true."""
        n, vt = mask.shape
        if n > self.rows or vt > self.mask.shape[1]:
            raise ValueError(
                f"FSM tables of {n} x {vt} exceed the {self.rows} x "
                f"{self.mask.shape[1]} buffers"
            )
        self.mask[:n, :vt].copy_(torch.from_numpy(mask))
        self.mask[1:n, vt:] = False
        self.dest[:n, :vt].copy_(torch.from_numpy(dest))
        self.dest[:n, vt:] = 0

    def allowed(self, fsm: torch.Tensor) -> torch.Tensor:
        """[B, V] bool: the tokens that both each row's table row ``fsm``
        and its host mask allow."""
        return self.mask.index_select(0, fsm) & self.host_mask

    def advance(self, fsm: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
        """Each row's table row after ``tok``."""
        return torch.take(self.dest, fsm.long() * self.dest.shape[1] + tok)


# Alternatives kept per position: OpenAI caps top_logprobs at 20, and a
# fixed width keeps the shapes static.
LOGPROB_TOP = 20


@dataclass
class SamplingExtras(StaticBuffers):
    """OpenAI ``logit_bias``, presence and frequency penalties and
    logprobs, shared by the decode step and every mixed bucket. The
    engine loads ``bias``, ``counts``, ``pres`` and ``freq`` for the rows
    that ask for them and keeps every other row at zero; the bodies add
    one to ``counts[row, token]`` for each token a row emits and write the
    logprob outputs of every row."""

    bias: torch.Tensor          # [B, V] f32 each row's static logit_bias
    counts: torch.Tensor        # [B, V] f32 tokens each row has emitted
    pres: torch.Tensor          # [B] f64 presence penalty
    freq: torch.Tensor          # [B] f64 frequency penalty
    lp: torch.Tensor            # [B, decode_block] f32 the picked token's logprob
    lp_ids: torch.Tensor        # [B, decode_block, 20] int32 the top 20 ids
    lp_top: torch.Tensor        # [B, decode_block, 20] f32 and their logprobs
    mixed_lp: torch.Tensor      # [B] f32, the same for a mixed tick
    mixed_lp_ids: torch.Tensor  # [B, 20] int32
    mixed_lp_top: torch.Tensor  # [B, 20] f32

    @classmethod
    def empty(
        cls, batch: int, vocab: int, decode_block: int, renderable: int,
        device: torch.device,
    ) -> SamplingExtras:
        """Buffers at zero. ``renderable``: the tokenizer's vocab; ids at or
        past it (a model's padded vocab) never appear among the top 20."""
        def zeros(*shape: int, dtype: torch.dtype = torch.float32) -> torch.Tensor:
            return torch.zeros(shape, dtype=dtype, device=device)

        out = cls(
            bias=zeros(batch, vocab), counts=zeros(batch, vocab),
            pres=zeros(batch, dtype=torch.float64), freq=zeros(batch, dtype=torch.float64),
            lp=zeros(batch, decode_block),
            lp_ids=zeros(batch, decode_block, LOGPROB_TOP, dtype=torch.int32),
            lp_top=zeros(batch, decode_block, LOGPROB_TOP), mixed_lp=zeros(batch),
            mixed_lp_ids=zeros(batch, LOGPROB_TOP, dtype=torch.int32),
            mixed_lp_top=zeros(batch, LOGPROB_TOP),
        )
        out.renderable = min(renderable, vocab)
        return out

    def adjust(self, logits: torch.Tensor) -> torch.Tensor:
        """``logits`` + each row's static bias minus, at each token it has
        emitted, presence + frequency x count: the JAX engine's
        ``logits + _bias_array(...)``, the bias taken from the counts on
        the device rather than rebuilt on the host each step. The penalty
        is summed in f64 and rounded once, as the JAX engine's host sum of
        Python floats is, so both give the same f32 bias."""
        pen = torch.where(
            self.counts > 0, self.pres[:, None] + self.freq[:, None] * self.counts, 0.0
        ).to(torch.float32)
        return logits + (self.bias - pen)

    def logprobs(
        self, adj: torch.Tensor, tok: torch.Tensor,
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(logprob of ``tok`` [B], top-20 ids [B, 20] int32, their logprobs
        [B, 20]) under ``log_softmax(adj)``, ids past ``renderable`` out of
        the top 20 (JAX's ``_decode_sample_lp``)."""
        lp = torch.log_softmax(adj.float(), dim=-1)
        chosen = lp.gather(1, tok[:, None])[:, 0]
        if self.renderable < lp.shape[1]:
            lp[:, self.renderable:] = float("-inf")
        top, ids = torch.topk(lp, LOGPROB_TOP, dim=-1)
        return chosen, ids.to(torch.int32), top

    def count(self, tok: torch.Tensor, emits: torch.Tensor) -> None:
        """One more of ``tok`` for each row that ``emits``."""
        self.counts.scatter_add_(1, tok[:, None], emits.to(self.counts.dtype)[:, None])


@dataclass
class DecodeState(StaticBuffers):
    """The block's loop state, one set of buffers per engine."""

    tok: torch.Tensor         # [B] int64 last sampled (not yet written) token
    at: torch.Tensor          # [B] int32 tokens already written to cache
    act: torch.Tensor         # [B] bool row still emitting
    eos: torch.Tensor         # [B] bool row sampled EOS in this block
    budgets: torch.Tensor     # [B] int32 max tokens each row may emit now
    step: torch.Tensor        # [] int64 steps run in this block
    page_table: torch.Tensor  # [B, MaxP] int32 pages pre-booked for the block
    temps: torch.Tensor       # [B] float32
    top_k: torch.Tensor       # [B] int32
    top_p: torch.Tensor       # [B] float32
    fsm: torch.Tensor         # [B] int32 FsmTables row (0 = unconstrained)
    out: torch.Tensor         # [B, decode_block] int64 tokens, pad past a finish

    @classmethod
    def empty(
        cls, batch: int, max_pages: int, decode_block: int, device: torch.device,
    ) -> DecodeState:
        def zeros(*shape: int, dtype: torch.dtype) -> torch.Tensor:
            return torch.zeros(shape, dtype=dtype, device=device)

        return cls(
            tok=zeros(batch, dtype=torch.long), at=zeros(batch, dtype=torch.int32),
            act=zeros(batch, dtype=torch.bool), eos=zeros(batch, dtype=torch.bool),
            budgets=zeros(batch, dtype=torch.int32), step=zeros(dtype=torch.long),
            page_table=zeros(batch, max_pages, dtype=torch.int32),
            temps=zeros(batch, dtype=torch.float32),
            top_k=zeros(batch, dtype=torch.int32),
            top_p=zeros(batch, dtype=torch.float32),
            fsm=zeros(batch, dtype=torch.int32),
            out=zeros(batch, decode_block, dtype=torch.long),
        )

    def load(
        self,
        tokens: np.ndarray,       # [B] int last sampled (not yet written) token
        write_at: np.ndarray,     # [B] int tokens already written to cache
        active: np.ndarray,       # [B] bool
        budgets: np.ndarray,      # [B] int max tokens each row may emit now
        page_table: np.ndarray,   # [B, MaxP] int32
        temps: np.ndarray,        # [B] float32
        top_k: np.ndarray,        # [B] int
        top_p: np.ndarray,        # [B] float32
        fsm: np.ndarray | None = None,  # [B] int FsmTables rows; None = all 0
        override: np.ndarray | None = None,  # [B] bool; None = all rows
    ) -> None:
        """Copy one block's host inputs into the buffers and start the
        block, the step at 0.

        Without ``override`` every row starts from the host: ``tokens``,
        ``write_at`` and ``fsm``, no EOS seen, active when the host says so
        and it has a budget. With it (JAX's ``decode_block_carry``), only
        the rows it marks start from the host; every other row carries its
        last token, write offset, FSM row and EOS flag over from the
        previous block on the device, whose tokens the host may not have
        seen yet, and is active when ``active`` (JAX's ``alive``), not past
        EOS and with a budget."""
        fsm = np.zeros(len(tokens), np.int32) if fsm is None else fsm
        self._copy_in((
            (self.budgets, budgets), (self.page_table, page_table),
            (self.temps, temps), (self.top_k, top_k), (self.top_p, top_p),
        ))
        if override is None:
            self._copy_in(((self.tok, tokens), (self.at, write_at),
                           (self.act, active & (budgets > 0)), (self.fsm, fsm)))
            self.eos.zero_()
        else:
            ov = self._staged(override, self.act)
            self.tok.copy_(torch.where(ov, self._staged(tokens, self.tok), self.tok))
            self.at.copy_(torch.where(ov, self._staged(write_at, self.at), self.at))
            self.fsm.copy_(torch.where(ov, self._staged(fsm, self.fsm), self.fsm))
            self.eos.logical_and_(~ov)
            self.act.copy_(self._staged(active, self.act) & ~self.eos & (self.budgets > 0))
        self.step.zero_()


def decode_step_body(
    model: Llama,
    state: DecodeState,
    cache: PagedKVCache,
    generator: torch.Generator,
    eos_id: int,
    pad_id: int,
    greedy: bool,
    plain: bool = False,
    backend: str = "dma",
    *,
    tables: FsmTables,
    extras: SamplingExtras | None = None,
) -> None:
    """One decode + sample step over ``state``, in place: writes each
    active row's K/V, adjusts the logits by ``extras`` (bias and
    penalties), masks them by ``tables`` at each row's ``fsm``, samples
    (``greedy``: an argmax, the sampler otherwise), writes the logprob
    outputs and the counts of ``extras``, advances the active rows'
    ``fsm``, writes column ``state.step`` of ``state.out``, advances the
    write offsets, retires rows that sampled EOS or spent their budget,
    and increments ``state.step``. ``plain`` and ``backend`` pass to
    ``Llama.decode_step``. No host sync."""
    s = state
    logits = model.decode_step(s.tok, s.at, cache, s.page_table, s.act, plain, backend)
    if extras is not None:
        logits = extras.adjust(logits)
    allowed = tables.allowed(s.fsm)
    if greedy:
        nxt = torch.where(allowed, logits, NEG_INF).argmax(dim=-1)
    else:
        nxt = sample(logits, generator, s.temps, s.top_k, s.top_p, allowed)
    nxt = torch.where(s.act, nxt, s.tok)
    if extras is not None:
        col = s.step.view(1)
        chosen, ids, top = extras.logprobs(logits, nxt)
        extras.lp.index_copy_(1, col, chosen[:, None])
        extras.lp_ids.index_copy_(1, col, ids[:, None])
        extras.lp_top.index_copy_(1, col, top[:, None])
        extras.count(nxt, s.act)
    s.fsm.copy_(torch.where(s.act, tables.advance(s.fsm, nxt), s.fsm))
    s.out.index_copy_(1, s.step.view(1), torch.where(s.act, nxt, pad_id)[:, None])
    s.at.add_(s.act.to(torch.int32))
    s.eos.logical_or_(s.act & (nxt == eos_id))
    s.act.logical_and_(~s.eos & (s.step + 1 < s.budgets))
    s.tok.copy_(nxt)
    s.step.add_(1)


def decode_block(
    state: DecodeState,
    step: Callable[[], None],
    tokens: np.ndarray,
    write_at: np.ndarray,
    active: np.ndarray,
    budgets: np.ndarray,
    page_table: np.ndarray,
    temps: np.ndarray,
    top_k: np.ndarray,
    top_p: np.ndarray,
    n_steps: int,
    fsm: np.ndarray | None = None,
    override: np.ndarray | None = None,
) -> torch.Tensor:
    """Load the host's inputs (``DecodeState.load``, with ``override`` the
    carry form) and run ``step`` — the body over ``state``, or a graph's
    replay of it — ``n_steps`` times. Returns the block's tokens
    [B, n_steps] int64 on the device, pad past each row's finish."""
    if not 0 < n_steps <= state.out.shape[1]:
        raise ValueError(f"n_steps={n_steps}: the block holds 1..{state.out.shape[1]}")
    state.load(tokens, write_at, active, budgets, page_table, temps, top_k, top_p, fsm,
               override)
    for _ in range(n_steps):
        step()
    return state.out[:, :n_steps]


@dataclass
class MixedState(StaticBuffers):
    """One mixed tick's inputs and sampled tokens at one query-axis bucket
    ``S``; one per bucket per engine."""

    tokens: torch.Tensor      # [B, S] int64 ragged rows, right-padded
    start: torch.Tensor       # [B] int32 write offsets
    q_lens: torch.Tensor      # [B] int32 valid rows (0 = inactive)
    page_table: torch.Tensor  # [B, MaxP] int32
    temps: torch.Tensor       # [B] float32
    top_k: torch.Tensor       # [B] int32
    top_p: torch.Tensor       # [B] float32
    fsm: torch.Tensor         # [B] int32 FsmTables row (0 = unconstrained):
                              # the host's (JAX's ov_fsm) in, the row after
                              # the tick out
    emits: torch.Tensor       # [B] bool row's token is output (advances fsm)
    use_carry: torch.Tensor   # [B] bool row's input token and FSM row are
                              # the previous tick's, never seen by the host
    carry_tok: torch.Tensor   # [B] int64 the previous tick's ``out``
    carry_fsm: torch.Tensor   # [B] int32 the previous tick's ``fsm``
    out: torch.Tensor         # [B] int64 each row's sampled token

    @classmethod
    def empty(cls, batch: int, S: int, max_pages: int, device: torch.device) -> MixedState:
        def zeros(*shape: int, dtype: torch.dtype) -> torch.Tensor:
            return torch.zeros(shape, dtype=dtype, device=device)

        return cls(
            tokens=zeros(batch, S, dtype=torch.long), start=zeros(batch, dtype=torch.int32),
            q_lens=zeros(batch, dtype=torch.int32),
            page_table=zeros(batch, max_pages, dtype=torch.int32),
            temps=zeros(batch, dtype=torch.float32), top_k=zeros(batch, dtype=torch.int32),
            top_p=zeros(batch, dtype=torch.float32), fsm=zeros(batch, dtype=torch.int32),
            emits=zeros(batch, dtype=torch.bool), use_carry=zeros(batch, dtype=torch.bool),
            carry_tok=zeros(batch, dtype=torch.long),
            carry_fsm=zeros(batch, dtype=torch.int32), out=zeros(batch, dtype=torch.long),
        )

    def load(
        self,
        tokens: np.ndarray,       # [B, S] int
        start: np.ndarray,        # [B] int
        q_lens: np.ndarray,       # [B] int
        page_table: np.ndarray,   # [B, MaxP] int32
        temps: np.ndarray,        # [B] float32
        top_k: np.ndarray,        # [B] int
        top_p: np.ndarray,        # [B] float32
        fsm: np.ndarray | None = None,    # [B] int FsmTables rows; None = all 0
        emits: np.ndarray | None = None,  # [B] bool; None = none
        use_carry: np.ndarray | None = None,  # [B] bool; None = none
        carry: MixedState | None = None,  # the tick whose out/fsm carry over
    ) -> None:
        """Copy one tick's host inputs into the buffers, and with ``carry``
        that tick's sampled tokens and FSM rows into ``carry_tok`` and
        ``carry_fsm``, on the device, in stream order: the rows marked
        ``use_carry`` read them in place of ``tokens[:, 0]`` and ``fsm``.
        The carry is copied first: ``carry`` may be this state."""
        B = len(start)
        if carry is not None:
            self.carry_tok.copy_(carry.out)
            self.carry_fsm.copy_(carry.fsm)
        self._copy_in((
            (self.tokens, tokens), (self.start, start), (self.q_lens, q_lens),
            (self.page_table, page_table), (self.temps, temps),
            (self.top_k, top_k), (self.top_p, top_p),
            (self.fsm, np.zeros(B, np.int32) if fsm is None else fsm),
            (self.emits, np.zeros(B, bool) if emits is None else emits),
            (self.use_carry, np.zeros(B, bool) if use_carry is None else use_carry),
        ))


def mixed_step_body(
    model: Llama,
    state: MixedState,
    cache: PagedKVCache,
    generator: torch.Generator,
    plain: bool = False,
    backend: str = "dma",
    *,
    tables: FsmTables,
    extras: SamplingExtras | None = None,
) -> None:
    """One mixed tick over ``state``, in place: ``Llama.mixed_step`` writes
    every row's valid K/V, and each row's token from its last valid
    position's logits, adjusted by ``extras`` and masked by ``tables`` at
    the row's FSM row, goes to ``state.out``, its logprobs to ``extras``'
    mixed outputs. Every row samples; the caller discards the rows whose
    chunk does not finish a prompt, and only the rows that emit advance
    their FSM row and their counts. No host sync.

    The carry form (JAX's ``mixed_step_carry``): a row marked
    ``use_carry`` takes its input token from ``carry_tok`` and its FSM row
    from ``carry_fsm``, the previous tick's outputs, so that the tick can
    be enqueued before the host has pulled them (the async mixed ticks of
    ``serving.async_runtime``). A sync tick marks no row."""
    state.tokens[:, 0] = torch.where(state.use_carry, state.carry_tok, state.tokens[:, 0])
    logits = model.mixed_step(
        state.tokens, state.start, state.q_lens, cache, state.page_table, plain, backend,
    )
    fstate = torch.where(state.use_carry, state.carry_fsm, state.fsm)
    tok = pick_rows(logits, fstate, state.emits, state.temps, state.top_k, state.top_p,
                    generator, tables, extras)
    state.out.copy_(tok)
    state.fsm.copy_(torch.where(state.emits, tables.advance(fstate, tok), fstate))


def pick_rows(
    logits: torch.Tensor,       # [B, V] f32 each row's last position
    fsm: torch.Tensor,          # [B] int32 FsmTables rows
    emits: torch.Tensor,        # [B] bool rows whose token is output
    temps: torch.Tensor,
    top_k: torch.Tensor,
    top_p: torch.Tensor,
    generator: torch.Generator,
    tables: FsmTables,
    extras: SamplingExtras | None = None,
) -> torch.Tensor:
    """The token of each row of a mixed tick or a split-lane prefill chunk
    [B] int64: the logits adjusted by ``extras``, masked by ``tables`` at
    ``fsm``, sampled; with ``extras`` the logprobs go to its mixed outputs
    and the rows that ``emits`` count their token. No host sync."""
    if extras is not None:
        logits = extras.adjust(logits)
    tok = sample(logits, generator, temps, top_k, top_p, tables.allowed(fsm))
    if extras is not None:
        chosen, ids, top = extras.logprobs(logits, tok)
        extras.mixed_lp.copy_(chosen)
        extras.mixed_lp_ids.copy_(ids)
        extras.mixed_lp_top.copy_(top)
        extras.count(tok, emits)
    return tok


# -- speculative decoding (prompt lookup, JAX's ngram_draft and
#    speculative_block_carry) ----------------------------------------------
def ngram_draft(
    hist: torch.Tensor,     # [B, H] token history (prompt + accepted tokens)
    at: torch.Tensor,       # [B] written-token counts (hist[:, :at] is real)
    tok: torch.Tensor,      # [B] next input token (not yet in hist)
    k: int,                 # draft length
    ngram: int,             # match length, tok its last item
) -> torch.Tensor:
    """Prompt-lookup drafting on the device: the last earlier occurrence of
    each row's trailing ``ngram`` (history tail + ``tok``) and the k tokens
    that followed it [B, k], or -1 where none is found (a -1 draft never
    matches the model's pick, so it fails verification). The candidate
    must end strictly before the tail itself, and its k tokens must be
    written history."""
    B, H = hist.shape
    g = ngram
    iota_g = torch.arange(g, device=hist.device)
    gpos = at.long()[:, None] - (g - 1) + iota_g[None, :]
    gram = hist.gather(1, gpos.clamp(0, H - 1))
    gram = torch.cat([gram[:, :-1], tok.to(hist.dtype)[:, None]], dim=1)
    W = H - g + 1
    eq = torch.ones((B, W), dtype=torch.bool, device=hist.device)
    for i in range(g):
        eq &= hist[:, i: W + i] == gram[:, i: i + 1]
    jpos = torch.arange(W, device=hist.device)[None, :]
    ok = eq & (jpos + g + k - 1 <= at.long()[:, None] - 1)
    j = torch.where(ok, jpos, -1).amax(dim=1)
    dpos = j[:, None] + g + torch.arange(k, device=hist.device)[None, :]
    draft = hist.gather(1, dpos.clamp(0, H - 1))
    return torch.where(j[:, None] >= 0, draft, -1)


@dataclass
class SpecState(StaticBuffers):
    """The speculative block's buffers beside a ``DecodeState``, whose
    ``tok``, ``at``, ``eos``, ``act``, ``budgets``, ``page_table`` and
    ``step`` it shares: so a row's carry passes between speculative and
    plain blocks on the device, as JAX's one carry does."""

    hist: torch.Tensor        # [B, H + 1] int64 each row's tokens by position;
                              # column H takes the writes JAX drops
    emitted: torch.Tensor     # [B] int32 tokens emitted in this block
    out: torch.Tensor         # [B, n_steps, k + 1] int64, pad past each count
    counts: torch.Tensor      # [B, n_steps] int32 tokens each step emitted

    @classmethod
    def empty(
        cls, batch: int, history: int, n_steps: int, k: int, device: torch.device,
    ) -> SpecState:
        return cls(
            hist=torch.zeros((batch, history + 1), dtype=torch.long, device=device),
            emitted=torch.zeros((batch,), dtype=torch.int32, device=device),
            out=torch.zeros((batch, n_steps, k + 1), dtype=torch.long, device=device),
            counts=torch.zeros((batch, n_steps), dtype=torch.int32, device=device),
        )

    @property
    def k(self) -> int:
        return self.out.shape[2] - 1

    def load(self, history: dict[int, list[int]]) -> None:
        """Start a block: no token emitted yet, and each row in ``history``
        (the rows the host seats now: JAX's override rows) gets its tokens
        by position; every other row keeps the history it carries."""
        self.emitted.zero_()
        if not history:
            return
        H = self.hist.shape[1] - 1
        rows = np.fromiter(history, np.int64, len(history))
        ids = np.zeros((len(rows), H + 1), np.int64)
        for n, row in enumerate(rows):
            toks = history[int(row)][:H]
            ids[n, : len(toks)] = toks
        self.hist.index_copy_(0, self._staged(rows, self.hist),
                              self._staged(ids, self.hist))


def speculative_step_body(
    model: Llama,
    state: DecodeState,
    spec: SpecState,
    cache: PagedKVCache,
    eos_id: int,
    pad_id: int,
    ngram: int,
    plain: bool = False,
    backend: str = "dma",
) -> None:
    """One greedy speculative iteration over ``state`` and ``spec``, in place
    (JAX's ``speculative_block_carry`` scan body): draft k tokens from each
    row's history (``ngram_draft``), verify [tok, draft] in one
    ``Llama.verify_step`` over min(k + 1, tokens left) positions, and emit
    the longest accepted prefix of the draft plus the model's own next
    token, stopping after an EOS and at the row's budget: 1 to k + 1
    tokens a row per weight stream. The accepted inputs join the history,
    the write offset advances by the count (a rejected position's K/V is
    overwritten later), and column ``state.step`` of ``spec.out`` and
    ``spec.counts`` get the step's tokens and counts. No host sync."""
    s, k = state, spec.k
    iota = torch.arange(k + 1, device=s.tok.device)[None, :]
    rem = s.budgets - spec.emitted
    hist = spec.hist[:, :-1]
    draft = ngram_draft(hist, s.at, s.tok, k, ngram)
    inputs = torch.cat([s.tok[:, None], draft], dim=1)               # [B, k+1]
    valid = torch.where(s.act, rem.clamp(max=k + 1), 0).to(torch.int32)
    logits = model.verify_step(inputs, s.at, valid, cache, s.page_table, plain, backend)
    a = logits.argmax(dim=-1)                                        # [B, k+1]
    ones = torch.ones_like(a[:, :1])
    can = torch.cat([ones, (draft == a[:, :k]).long().cumprod(1)], dim=1)
    no_eos_before = torch.cat([ones, (a[:, :k] != eos_id).long()], dim=1).cumprod(1)
    emit = ((can * no_eos_before) > 0) & (iota < rem[:, None]) & s.act[:, None]
    n_emit = emit.sum(1, dtype=torch.int32)
    # The accepted inputs land in the history at at .. at + n_emit - 1;
    # the rest at the scratch column, as JAX drops them.
    H = hist.shape[1]
    wpos = s.at.long()[:, None] + iota
    spec.hist.scatter_(1, torch.where((iota < n_emit[:, None]) & (wpos < H), wpos, H),
                       inputs)
    spec.out.index_copy_(1, s.step.view(1), torch.where(emit, a, pad_id)[:, None])
    spec.counts.index_copy_(1, s.step.view(1), n_emit[:, None])
    last = a.gather(1, (n_emit.long() - 1).clamp(0, k)[:, None])[:, 0]
    s.eos.logical_or_((emit & (a == eos_id)).any(1))
    s.tok.copy_(torch.where(n_emit > 0, last, s.tok))
    s.at.add_(n_emit)
    spec.emitted.add_(n_emit)
    s.act.logical_and_(~s.eos & (spec.emitted < s.budgets))
    s.step.add_(1)


def speculative_block(
    state: DecodeState,
    spec: SpecState,
    step: Callable[[], None],
    tokens: np.ndarray,
    write_at: np.ndarray,
    active: np.ndarray,
    budgets: np.ndarray,
    page_table: np.ndarray,
    n_steps: int,
    history: dict[int, list[int]],
    override: np.ndarray | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Load a greedy block (``DecodeState.load``, with ``override`` the carry
    form, and ``SpecState.load`` with the seated rows' ``history``) and run
    ``step`` (the speculative body or its graph's replay) ``n_steps``
    times. Returns the tokens [B, n_steps, k + 1] and each step's counts
    [B, n_steps] on the device."""
    if not 0 < n_steps <= spec.out.shape[1]:
        raise ValueError(f"n_steps={n_steps}: the block holds 1..{spec.out.shape[1]}")
    B = len(tokens)
    greedy = np.zeros(B, np.float32)
    state.load(tokens, write_at, active, budgets, page_table, greedy,
               np.zeros(B, np.int32), np.ones(B, np.float32), override=override)
    spec.load(history)
    for _ in range(n_steps):
        step()
    return spec.out[:, :n_steps], spec.counts[:, :n_steps]


# -- host-side dispatch telemetry (JAX decode_loop.py's record_dispatch) ------
def _record_attr(kind: str, attr, attr_kw: dict | None) -> None:
    """Forward one dispatch's composition to the goodput ledger's cost
    model (obs/attribution.py). Host float math only; never raises into
    the dispatch path."""
    if attr is None:
        return
    try:
        attr.dispatch(kind, **(attr_kw or {}))
    except Exception:  # noqa: BLE001 - attribution must not kill serving
        pass


def record_dispatch(
    kind: str, rows: int, steps: int, attr=None, attr_kw: dict | None = None
) -> None:
    """Host-side telemetry of one decode block call. Nothing records
    inside ``decode_step_body``: where steps replay, its Python runs once,
    at capture, so a counter there would count captures, not steps. The
    engine calls this once per block call: ``kind`` is "block", ``rows``
    how many lanes got a budget and ``steps`` the block's ``n_steps``.
    ``attr``/``attr_kw`` carry the block's roofline composition to the
    attribution ledger."""
    from .. import obs

    obs.DECODE_DISPATCHES.inc(kind=kind)
    if rows > 0 and steps > 0:
        obs.get_registry().histogram(
            "opsagent_decode_dispatch_rows",
            "Budgeted lanes per decode dispatch",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128),
        ).observe(rows)
    _record_attr(kind, attr, attr_kw)


def record_mixed_dispatch(
    decode_rows: int, prefill_tokens: int, budget: int,
    attr=None, attr_kw: dict | None = None,
) -> None:
    """Composition telemetry of one mixed tick (``Engine.step_mixed``, once
    per tick that runs a forward, outside ``mixed_step_body``): how many
    decode lanes rode the tick, how many prefill chunk tokens shared its
    weight stream, and what fraction of the tick's token budget
    (``max_step_tokens``) the two together used."""
    from .. import obs

    obs.DECODE_DISPATCHES.inc(kind="mixed")
    obs.MIXED_DECODE_LANES.observe(max(0, decode_rows))
    obs.MIXED_PREFILL_TOKENS.observe(max(0, prefill_tokens))
    if budget > 0:
        obs.MIXED_BUDGET_UTILIZATION.observe(
            min(1.0, (decode_rows + prefill_tokens) / budget)
        )
    _record_attr("mixed", attr, attr_kw)


def record_async_dispatch(
    decode_rows: int, prefill_tokens: int, budget: int, depth: int,
    attr=None, attr_kw: dict | None = None,
) -> None:
    """Telemetry of one async mixed tick (``serving.async_runtime``): the
    composition series of a sync tick plus the in-flight depth, ``depth``
    counting this tick. No ``measured_s``: the tick is enqueued, not
    waited for, so its wall time measures no step."""
    from .. import obs

    obs.DECODE_DISPATCHES.inc(kind="mixed_async")
    obs.MIXED_DECODE_LANES.observe(max(0, decode_rows))
    obs.MIXED_PREFILL_TOKENS.observe(max(0, prefill_tokens))
    if budget > 0:
        obs.MIXED_BUDGET_UTILIZATION.observe(
            min(1.0, (decode_rows + prefill_tokens) / budget)
        )
    obs.ASYNC_INFLIGHT_DEPTH.set(depth)
    _record_attr("mixed_async", attr, attr_kw)


def record_async_commit(overlapped: bool, depth_after: int) -> None:
    """One committed async tick; ``overlapped`` when a newer tick was
    still enqueued while its host work ran."""
    from .. import obs

    obs.ASYNC_COMMITS.inc()
    if overlapped:
        obs.ASYNC_OVERLAPPED_COMMITS.inc()
    obs.ASYNC_INFLIGHT_DEPTH.set(depth_after)


def record_ffwd_append(
    seq_id: int, run_len: int, attr=None, request_id: str | None = None,
) -> None:
    """One forced run of ``run_len`` tokens appended by the grammar
    fast-forward, each a forward the run skipped: the run, token and
    skipped-dispatch counters, a ``ffwd`` flight event, and the skipped
    dispatches charged to the attribution ledger at no weight stream (the
    append's own dispatch carries the run's KV and attention work)."""
    from .. import obs

    obs.FFWD_RUNS.inc()
    obs.FFWD_TOKENS.inc(run_len)
    obs.FFWD_SKIPPED_DISPATCHES.inc(run_len)
    obs.flight.record("ffwd", seq_id=seq_id, run_len=run_len, request_id=request_id)
    if attr is not None:
        for _ in range(run_len):
            _record_attr("ffwd", attr, dict(weight_streams=0.0))
