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
over a ``MixedState``, one per query-axis bucket (JAX's prefill programs,
one per bucket).

Constrained decoding runs inside both bodies (JAX's ``decode_block_carry``
and ``mixed_step_carry``): each row's ``fsm`` indexes the loaded schema's
``FsmTables``, whose row 0 allows everything, and a ``host_mask`` row
carries a mask the host computed. Every row's logits are masked by both
before it picks, and the rows that emit advance their ``fsm`` through the
destination table on the device. Unconstrained rows sit at row 0 with an
all-true host row, so the same bodies, and the same graphs, serve every
kind of row.
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
        for buf, a in pairs:
            buf.copy_(torch.from_numpy(np.ascontiguousarray(a)))


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
    ) -> None:
        """Copy one block's host inputs into the buffers and start the
        block: a row is active when the host says so and it has a budget,
        no row has seen EOS, the step is 0."""
        self._copy_in((
            (self.tok, tokens), (self.at, write_at),
            (self.act, active & (budgets > 0)), (self.budgets, budgets),
            (self.page_table, page_table), (self.temps, temps),
            (self.top_k, top_k), (self.top_p, top_p),
            (self.fsm, np.zeros(len(tokens), np.int32) if fsm is None else fsm),
        ))
        self.eos.zero_()
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
) -> None:
    """One decode + sample step over ``state``, in place: writes each
    active row's K/V, masks the logits by ``tables`` at each row's ``fsm``,
    samples (``greedy``: an argmax, the sampler otherwise), advances the
    active rows' ``fsm``, writes column ``state.step`` of ``state.out``,
    advances the write offsets, retires rows that sampled EOS or spent
    their budget, and increments ``state.step``. ``plain`` and ``backend``
    pass to ``Llama.decode_step``. No host sync."""
    s = state
    logits = model.decode_step(s.tok, s.at, cache, s.page_table, s.act, plain, backend)
    allowed = tables.allowed(s.fsm)
    if greedy:
        nxt = torch.where(allowed, logits, NEG_INF).argmax(dim=-1)
    else:
        nxt = sample(logits, generator, s.temps, s.top_k, s.top_p, allowed)
    nxt = torch.where(s.act, nxt, s.tok)
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
) -> torch.Tensor:
    """Load the host's inputs (``DecodeState.load``) and run ``step`` — the
    body over ``state``, or a graph's replay of it — ``n_steps`` times.
    Returns the block's tokens [B, n_steps] int64 on the device, pad past
    each row's finish."""
    if not 0 < n_steps <= state.out.shape[1]:
        raise ValueError(f"n_steps={n_steps}: the block holds 1..{state.out.shape[1]}")
    state.load(tokens, write_at, active, budgets, page_table, temps, top_k, top_p, fsm)
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
    fsm: torch.Tensor         # [B] int32 FsmTables row (0 = unconstrained)
    emits: torch.Tensor       # [B] bool row's token is output (advances fsm)
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
            emits=zeros(batch, dtype=torch.bool), out=zeros(batch, dtype=torch.long),
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
    ) -> None:
        B = len(start)
        self._copy_in((
            (self.tokens, tokens), (self.start, start), (self.q_lens, q_lens),
            (self.page_table, page_table), (self.temps, temps),
            (self.top_k, top_k), (self.top_p, top_p),
            (self.fsm, np.zeros(B, np.int32) if fsm is None else fsm),
            (self.emits, np.zeros(B, bool) if emits is None else emits),
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
) -> None:
    """One mixed tick over ``state``, in place: ``Llama.mixed_step`` writes
    every row's valid K/V, and each row's token from its last valid
    position's logits, masked by ``tables`` at the row's ``fsm``, goes to
    ``state.out``. Every row samples; the caller discards the rows whose
    chunk does not finish a prompt, and only the rows that emit advance
    their ``fsm``. No host sync."""
    logits = model.mixed_step(
        state.tokens, state.start, state.q_lens, cache, state.page_table, plain, backend,
    )
    allowed = tables.allowed(state.fsm)
    tok = sample(logits, generator, state.temps, state.top_k, state.top_p, allowed)
    state.out.copy_(tok)
    state.fsm.copy_(torch.where(state.emits, tables.advance(state.fsm, tok), state.fsm))
