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
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Callable

import numpy as np
import torch

from ..models.llama import Llama, PagedKVCache
from .sampler import sample


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
    ) -> None:
        """Copy one block's host inputs into the buffers and start the
        block: a row is active when the host says so and it has a budget,
        no row has seen EOS, the step is 0."""
        self._copy_in((
            (self.tok, tokens), (self.at, write_at),
            (self.act, active & (budgets > 0)), (self.budgets, budgets),
            (self.page_table, page_table), (self.temps, temps),
            (self.top_k, top_k), (self.top_p, top_p),
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
) -> None:
    """One decode + sample step over ``state``, in place: writes each
    active row's K/V, samples (``greedy``: an argmax, the sampler
    otherwise), writes column ``state.step`` of ``state.out``, advances the
    write offsets, retires rows that sampled EOS or spent their budget, and
    increments ``state.step``. ``plain`` and ``backend`` pass to
    ``Llama.decode_step``. No host sync."""
    s = state
    logits = model.decode_step(s.tok, s.at, cache, s.page_table, s.act, plain, backend)
    if greedy:
        nxt = logits.argmax(dim=-1)
    else:
        nxt = sample(logits, generator, s.temps, s.top_k, s.top_p)
    nxt = torch.where(s.act, nxt, s.tok)
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
) -> torch.Tensor:
    """Load the host's inputs (``DecodeState.load``) and run ``step`` — the
    body over ``state``, or a graph's replay of it — ``n_steps`` times.
    Returns the block's tokens [B, n_steps] int64 on the device, pad past
    each row's finish."""
    if not 0 < n_steps <= state.out.shape[1]:
        raise ValueError(f"n_steps={n_steps}: the block holds 1..{state.out.shape[1]}")
    state.load(tokens, write_at, active, budgets, page_table, temps, top_k, top_p)
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
            top_p=zeros(batch, dtype=torch.float32), out=zeros(batch, dtype=torch.long),
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
    ) -> None:
        self._copy_in((
            (self.tokens, tokens), (self.start, start), (self.q_lens, q_lens),
            (self.page_table, page_table), (self.temps, temps),
            (self.top_k, top_k), (self.top_p, top_p),
        ))


def mixed_step_body(
    model: Llama,
    state: MixedState,
    cache: PagedKVCache,
    generator: torch.Generator,
    plain: bool = False,
    backend: str = "dma",
) -> None:
    """One mixed tick over ``state``, in place: ``Llama.mixed_step`` writes
    every row's valid K/V, and each row's token from its last valid
    position's logits goes to ``state.out``. Every row samples; the caller
    discards the rows whose chunk does not finish a prompt. No host sync."""
    logits = model.mixed_step(
        state.tokens, state.start, state.q_lens, cache, state.page_table, plain, backend,
    )
    state.out.copy_(sample(logits, generator, state.temps, state.top_k, state.top_p))
