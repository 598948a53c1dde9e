"""One-tick-lookahead async mixed ticks (the port's counterpart of
``opsagent_tpu/serving/async_runtime.py``).

A synchronous mixed tick replays its graph, waits for its tokens, and only
then does the host work: detokenizing, the stop-string scan, streaming,
trie bookkeeping, planning the next tick; the card idles meanwhile. Here
the mixed ticks are a two-deep pipeline:

- **Plan (runs ahead)**: tick t+1 is built and replayed before tick t's
  tokens reach the host. The decode lanes' input tokens never visit the
  host: a lane that emitted in tick t reads its token and FSM row from tick
  t's output buffers on the card (``MixedState.carry_tok``/``carry_fsm``,
  ``decode_loop.mixed_step_body``), copied in stream order before the
  replay. Tick t's tokens are first copied into pinned host memory
  (``decode_loop.to_host``), so the replay may overwrite them.
- **Commit (lags one tick)**: the oldest tick's copy is waited for (its
  event, not the device) and its host work runs while the newer tick
  executes.

What the rest of the engine absorbs:

- EOS and stop strings are seen one tick late: a finished row's one
  overshoot token is discarded at commit and its page booking rolled back
  (``opsagent_async_overshoot_tokens_total``). The planner never books past
  ``max_tokens``, so a length finish is exact.
- A prompt whose last chunk is in flight keeps decoding through a
  *lookahead lane*: its first token exists only on the card, so it rides
  the next tick as a carry-fed decode row before the scheduler learns that
  the admission completed.
- Grammar fast-forward at every plan point: a constrained row whose FSM
  state forces a run appends the run in the tick that plans it and samples
  only the token after it.
- Rows needing host work per token (hosted masks, logprobs, bias) never
  ride this lane; the scheduler routes such ticks to the sync lanes.

The runtime works on the engine's state under the engine's lock; the
engine owns one (``Engine.step_mixed_async``, ``async_drain``).
"""

from __future__ import annotations

import logging
import time
import weakref
from collections import deque
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from .. import obs
from ..utils.perf import get_perf_stats
from ..utils.profiling import annotate
from .constrained import device_table_fsm
from .decode_loop import (
    from_host,
    record_async_commit,
    record_async_dispatch,
    record_ffwd_append,
    to_host,
)
from .kvcache import OutOfPages

log = logging.getLogger("opsagent_tpu_torch.async_runtime")


@dataclass
class _Tick:
    """One enqueued, uncommitted mixed tick."""

    host: torch.Tensor                # [B] its sampled tokens, being copied
    event: Any                        # when ``host`` holds them (None: CPU)
    decode: list = field(default_factory=list)   # [(seq_id, lane)]
    chunks: list = field(default_factory=list)   # [(seq_id, lane, done, c, finishing)]
    # Grammar fast-forward: seq_id -> the forced tokens this tick appended
    # before its sampled token (committed in order ahead of it).
    ffwd: dict = field(default_factory=dict)
    t_disp: float = 0.0
    tick_id: int = 0


class AsyncMixedRuntime:
    """Plan and commit of the async mixed ticks. Every method expects the
    caller to hold the engine's lock (the engine's wrappers do)."""

    def __init__(self, engine):
        # A proxy: the engine owns the runtime, and a cycle between them
        # would leave a dropped engine (its CUDA graphs, its cache) to the
        # garbage collector instead of freeing it at once.
        self.eng = weakref.proxy(engine)
        self._pending: deque[_Tick] = deque()
        # The previous tick's seating: a decode row continues from the
        # carry only if it emitted in that tick, in the same lane.
        self._prev_lane: dict[int, int] = {}
        self._prev_emitted: set[int] = set()
        # The previous tick's MixedState: its out/fsm are the carry.
        self._prev_state = None
        # Tokens sampled but not committed, per sequence: the budget guard
        # and the carry-continuity check.
        self._inflight_toks: dict[int, int] = {}
        # Prompts whose last chunk is enqueued but not committed: they ride
        # the next ticks as carry-fed lookahead lanes.
        self._finishing: set[int] = set()
        # Committed results not yet picked up (settles made by the sync
        # lanes commit here, so that no finished admission is lost).
        self._results: tuple[dict, dict] = ({}, {})
        self._tick_id = 0

    # -- public surface (through the engine's wrappers) ----------------------
    @property
    def pending(self) -> int:
        return len(self._pending)

    def inflight_tokens(self, seq_id: int) -> int:
        return self._inflight_toks.get(seq_id, 0)

    def take_results(self) -> tuple[dict[int, list[int]], dict[int, Any]]:
        d, p = self._results
        self._results = ({}, {})
        return d, p

    def step(
        self, decode_ids: list[int], prefill_chunks: dict[int, int]
    ) -> tuple[dict[int, list[int]], dict[int, Any]]:
        """Enqueue one tick (plan), then commit every tick past the
        configured depth. Returns what is committed so far, which at depth
        > 1 describes earlier ticks than the one just enqueued."""
        depth = max(1, self.eng.cfg.async_depth)
        dispatched = False
        if decode_ids or prefill_chunks or self._finishing:
            dispatched = self._dispatch(decode_ids, prefill_chunks)
        while len(self._pending) >= depth:
            self._commit_oldest()
        if not dispatched and self._pending:
            # Nothing enqueued (every row finished, covered or filtered): a
            # commit still makes progress for a caller that loops on us.
            self._commit_oldest()
        return self.take_results()

    def drain_decode(self) -> dict[int, list[int]]:
        """Flush, then hand back only the decode tokens; the prefill
        outcomes stay for ``take_results`` (the scheduler needs them)."""
        self.flush()
        d, p = self._results
        self._results = ({}, p)
        return d

    def flush(self) -> None:
        """Commit everything in flight and forget the seating: the next
        tick seats every row from the (now current) host state. The sync
        lanes call this before they touch shared state."""
        while self._pending:
            self._commit_oldest()
        self._prev_lane = {}
        self._prev_emitted = set()
        self._prev_state = None
        self._inflight_toks.clear()
        self._finishing.clear()

    # -- plan ------------------------------------------------------------------
    def _dispatch(
        self, decode_ids: list[int], prefill_chunks: dict[int, int]
    ) -> bool:
        eng = self.eng
        cfg = eng.cfg
        B = cfg.max_batch_size
        decode = [
            eng.sequences[s] for s in decode_ids
            if s in eng.sequences and not eng.sequences[s].done
        ]
        # Lookahead lanes: prompts whose last chunk is in flight decode
        # through the carry, whose token is their only one.
        seen = {s.seq_id for s in decode}
        for sid in sorted(self._finishing):
            if sid in seen:
                continue
            s = eng.sequences.get(sid)
            if (s is not None and not s.done
                    and sid in self._prev_lane and sid in self._prev_emitted):
                decode.append(s)
        # Carry continuity: a row with uncommitted tokens must have emitted
        # in the previous tick (its next input exists only in the carry).
        # A skipped tick means the caller reordered rows: settle, and every
        # row seats afresh.
        for s in decode:
            if self._inflight_toks.get(s.seq_id, 0) and (
                s.seq_id not in self._prev_lane or s.seq_id not in self._prev_emitted
            ):
                obs.ASYNC_FALLBACKS.inc(reason="carry_break")
                self.flush()
                break
        # Budget guard: never enqueue a token max_tokens cannot take, so a
        # length finish is exact.
        decode = [
            s for s in decode
            if not s.done
            and len(s.tokens) + self._inflight_toks.get(s.seq_id, 0) < s.params.max_tokens
        ]
        # Book the token each decode row writes. On a dry pool, committing
        # the pipeline can roll finished rows' bookings back: retry once.
        grown: list = []
        for s in decode:
            try:
                eng.alloc.extend(s.seq_id, 1)
                grown.append(s)
                continue
            except OutOfPages:
                pass
            self.flush()
            if s.done:
                continue
            try:
                eng.alloc.extend(s.seq_id, 1)
                grown.append(s)
            except OutOfPages:
                s.done, s.finish_reason = True, "length"
                eng._preempted(s)
        decode = [s for s in grown if not s.done]
        # Grammar fast-forward plans: a constrained row whose FSM state
        # forces a run appends it in this tick and samples only the token
        # after it. The host must pin the row's FSM state, so a row with
        # more than one uncommitted token waits for commits. A continuing
        # row's one uncommitted token was sampled at the forced state, so
        # it is run[0]: the row is fed from the host instead of the carry
        # and appends the rest.
        # plan: seq_id -> (anchor token, forced tokens, FsmTables row)
        ffwd_plan: dict[int, tuple[int, list[int], int]] = {}
        if cfg.grammar_ffwd:
            for s in decode:
                sid = s.seq_id
                inflight = self._inflight_toks.get(sid, 0)
                if inflight > 1:
                    continue
                fsm = device_table_fsm(s.mask_fn)
                if fsm is None:
                    continue
                st0 = s.mask_fn.dfa_state(s.tokens)
                run = fsm.forced_run(st0) if st0 >= 0 else []
                if run and run[-1] == fsm.eos_id:
                    # The masked sample at an EOS-only state picks EOS at
                    # any temperature: the trailing EOS needs no append.
                    run = run[:-1]
                if inflight == 1:
                    if (sid not in self._prev_lane or sid not in self._prev_emitted
                            or len(run) < 2):
                        continue
                    anchor, pre = run[0], run[1:]
                else:
                    if not run:
                        continue
                    anchor = s.tokens[-1] if s.tokens else eng.tokenizer.bos_id
                    pre = run
                # Never past max_tokens (the forced tokens and one sampled
                # on top of what is in flight) or the largest bucket.
                cap = min(
                    s.params.max_tokens - len(s.tokens) - inflight - 1,
                    cfg.mixed_buckets[-1] - 1,
                )
                pre = pre[: max(0, cap)]
                if not pre:
                    continue
                # The sample masks by the state after everything this tick
                # consumes past st0: the anchor too for a continuing row
                # (its uncommitted token was sampled at st0), the forced
                # tokens alone for a settled one.
                st = st0
                for t in ([anchor] + pre) if inflight == 1 else pre:
                    st = fsm.advance(st, t)
                try:
                    eng.alloc.extend(sid, len(pre))
                except OutOfPages:
                    eng.alloc.truncate(sid, eng.alloc.length(sid))
                    continue
                ffwd_plan[sid] = (int(anchor), pre, st + 1)
        chunk_info: list[tuple[int, Any, int, int]] = []
        smax = 1
        for _anchor, pre, _st in ffwd_plan.values():
            smax = max(smax, 1 + len(pre))
        for sid, want in prefill_chunks.items():
            seq = eng.sequences.get(sid)
            if seq is None or sid not in eng._prefilling:
                continue
            done = eng._prefilling[sid]
            c = min(want, cfg.mixed_buckets[-1], seq.prompt_len - done)
            if c <= 0:
                continue
            chunk_info.append((sid, seq, done, c))
            smax = max(smax, c)
        if not decode and not chunk_info:
            return False
        if len(decode) + len(chunk_info) > B:
            raise ValueError(
                f"async mixed batch of {len(decode)} decode + {len(chunk_info)} "
                f"prefill rows exceeds max_batch_size={B}"
            )
        # The rows that sample under a constraint ride the loaded table
        # set; one set per tick (the scheduler routes mixed schemas away).
        finishing_seqs = [seq for _sid, seq, done, c in chunk_info
                          if done + c >= seq.prompt_len]
        routes = eng._fsm_routes(decode + finishing_seqs)
        if not all(routes.values()):
            raise ValueError("a row off the loaded FSM tables in an async mixed tick")
        S = eng._mixed_bucket(smax)

        # Lanes: continuing decode rows keep theirs (the carry is indexed
        # by lane); every other row takes a free one.
        taken: set[int] = set()
        lane_of: dict[int, int] = {}
        continuing: set[int] = set()
        for s in decode:
            ln = self._prev_lane.get(s.seq_id)
            if ln is not None and s.seq_id in self._prev_emitted and ln not in taken:
                lane_of[s.seq_id] = ln
                taken.add(ln)
                continuing.add(s.seq_id)
        for sid, *_ in chunk_info:
            ln = self._prev_lane.get(sid)
            if ln is not None and ln not in taken:
                lane_of[sid] = ln
                taken.add(ln)
        free = [i for i in range(B) if i not in taken]
        for s in decode:
            if s.seq_id not in lane_of:
                lane_of[s.seq_id] = free.pop(0)
        for sid, *_ in chunk_info:
            if sid not in lane_of:
                lane_of[sid] = free.pop(0)

        tokens = np.full((B, S), eng.tokenizer.pad_id, np.int64)
        use_carry = np.zeros((B,), bool)
        starts = np.zeros((B,), np.int32)
        qlens = np.zeros((B,), np.int32)
        emits = np.zeros((B,), bool)
        ov_fsm = np.zeros((B,), np.int32)
        tables = np.full((B, cfg.max_pages_per_seq), -1, np.int32)
        slots: list = [None] * B
        dec_rows: list[tuple[Any, int]] = []
        for s in decode:
            lane = lane_of[s.seq_id]
            dec_rows.append((s, lane))
            slots[lane] = s
            plan = ffwd_plan.get(s.seq_id)
            q = 1 if plan is None else 1 + len(plan[1])
            qlens[lane] = q
            emits[lane] = True
            # The bookings made length = written + in flight + q; the row
            # writes its q inputs into the slots before it.
            starts[lane] = eng.alloc.length(s.seq_id) - q
            tables[lane] = eng.alloc.page_table_row(s.seq_id)
            if plan is not None:
                # Every input is known to the host (the anchor by
                # determinism): the carry is not read.
                anchor, pre, row = plan
                tokens[lane, :q] = [anchor] + pre
                ov_fsm[lane] = row
            elif s.seq_id in continuing:
                use_carry[lane] = True
            else:
                tokens[lane, 0] = s.tokens[-1] if s.tokens else eng.tokenizer.bos_id
                ov_fsm[lane] = eng._fsm_row(s, routes.get(s.seq_id, False))
        chk_rows: list[tuple[int, int, int, int, bool]] = []
        for sid, seq, done, c in chunk_info:
            lane = lane_of[sid]
            finishing = done + c >= seq.prompt_len
            chk_rows.append((sid, lane, done, c, finishing))
            slots[lane] = seq
            tokens[lane, :c] = seq.prompt_ids[done:done + c]
            starts[lane] = done
            qlens[lane] = c
            tables[lane] = eng.alloc.page_table_row(sid)
            emits[lane] = finishing
            if finishing:
                ov_fsm[lane] = eng._fsm_row(seq, routes.get(sid, False))
        temps, top_k, top_p = eng._sampling_arrays(slots, B)

        perf = get_perf_stats()
        now = time.perf_counter()
        if eng._mixed_gap_stamp is not None:
            gap = now - eng._mixed_gap_stamp
            obs.STEP_HOST_GAP_SECONDS.observe(gap, mode="async")
            perf.record_metric("engine.step_host_gap", gap * 1e3, "ms")
        t_disp = time.perf_counter()
        try:
            with torch.inference_mode(), annotate("engine.mixed_step_async"):
                eng._load_host_masks({})
                state = eng._mixed[S]
                carry = next((b for b, st in eng._mixed.items() if st is self._prev_state),
                             None)
                out = eng._device(
                    "mixed", S, False,
                    (tokens, starts, qlens, tables, temps, top_k, top_p, ov_fsm, emits,
                     use_carry), carry,
                )
                host, event = to_host(out)
        except Exception:
            # Salvage what the earlier ticks produced, then roll this one
            # back: its bookings are for tokens it never wrote, and its
            # chunk admissions are dropped as step_mixed drops them.
            try:
                self.flush()
            except Exception:  # noqa: BLE001 - the device may be gone
                log.exception("async pipeline salvage flush failed")
            for s, _lane in dec_rows:
                if not s.done and s.seq_id in eng.sequences:
                    plan = ffwd_plan.get(s.seq_id)
                    booked = 1 if plan is None else 1 + len(plan[1])
                    eng.alloc.truncate(s.seq_id, eng.alloc.length(s.seq_id) - booked)
            for sid, *_ in chk_rows:
                eng._drop_admission(sid)
            self._prev_lane = {}
            self._prev_emitted = set()
            self._prev_state = None
            raise
        self._prev_state = state
        eng.async_ticks += 1
        eng.ffwd_tokens += sum(len(p[1]) for p in ffwd_plan.values())
        eng._mixed_gap_stamp = time.perf_counter()
        perf.record_metric("engine.mixed_dispatch", (eng._mixed_gap_stamp - t_disp) * 1e3, "ms")
        n_prefill = int(sum(c for _s, _l, _d, c, _f in chk_rows))
        if n_prefill:
            perf.record_metric("engine.prefill_tokens", n_prefill, "tok")
            obs.PREFILL_TOKENS.inc(n_prefill)
        # Each decode row's true q: 1, or 1 + its forced run.
        dec_q = int(sum(int(qlens[lane]) for _s, lane in dec_rows))
        dec_ctx = int(sum(int(starts[lane]) + int(qlens[lane]) for _s, lane in dec_rows))
        positions = obs.attribution.prefill_attn_positions
        record_async_dispatch(
            decode_rows=len(dec_rows),
            prefill_tokens=n_prefill,
            budget=cfg.max_step_tokens,
            depth=len(self._pending) + 1,
            attr=eng.attr,
            attr_kw=dict(
                q_tokens=dec_q + n_prefill,
                kv_read_tokens=dec_ctx + int(sum(d + c for _s, _l, d, c, _f in chk_rows)),
                kv_write_tokens=dec_q + n_prefill,
                attn_q_ctx=int(sum(positions(int(starts[lane]), int(qlens[lane]))
                                   for _s, lane in dec_rows))
                + int(sum(positions(d, c) for _s, _l, d, c, _f in chk_rows)),
            ),
        )
        n_forced = int(sum(len(p[1]) for p in ffwd_plan.values()))
        for s, _lane in dec_rows:
            plan = ffwd_plan.get(s.seq_id)
            if plan is not None:
                record_ffwd_append(s.seq_id, len(plan[1]), attr=eng.attr,
                                   request_id=obs.flight.request_id_of(s.trace))
        self._tick_id += 1
        obs.flight.record(
            "dispatch", op="mixed",
            decode_seq_ids=[s.seq_id for s, _ in dec_rows],
            prefill_seq_ids=[sid for sid, *_ in chk_rows],
            bucket=int(S), prefill_tokens=n_prefill, forced_tokens=n_forced,
            budget=cfg.max_step_tokens, tick=self._tick_id,
            pipeline_pos=len(self._pending),
        )
        # Bookkeeping once the tick is enqueued: prefill progress advances
        # (the write is enqueued), this tick's finishing prompts join the
        # lookahead set, every emitting row has one more uncommitted token.
        for sid, _lane, done, c, finishing in chk_rows:
            eng._prefilling[sid] = done + c
            if finishing:
                self._finishing.add(sid)
                self._inflight_toks[sid] = self._inflight_toks.get(sid, 0) + 1
        self._prev_lane = {}
        self._prev_emitted = set()
        for s, lane in dec_rows:
            self._prev_lane[s.seq_id] = lane
            self._prev_emitted.add(s.seq_id)
            plan = ffwd_plan.get(s.seq_id)
            self._inflight_toks[s.seq_id] = (
                self._inflight_toks.get(s.seq_id, 0) + 1
                + (0 if plan is None else len(plan[1]))
            )
        for sid, lane, _done, _c, finishing in chk_rows:
            self._prev_lane[sid] = lane
            if finishing:
                self._prev_emitted.add(sid)
        self._pending.append(_Tick(
            host=host, event=event,
            decode=[(s.seq_id, lane) for s, lane in dec_rows],
            chunks=chk_rows,
            ffwd={sid: plan[1] for sid, plan in ffwd_plan.items()},
            t_disp=t_disp, tick_id=self._tick_id,
        ))
        return True

    # -- commit ----------------------------------------------------------------
    def _dec_inflight(self, sid: int, n: int = 1) -> None:
        left = self._inflight_toks.get(sid, 0) - n
        if left > 0:
            self._inflight_toks[sid] = left
        else:
            self._inflight_toks.pop(sid, None)

    def _commit_oldest(self) -> None:
        eng = self.eng
        tick = self._pending.popleft()
        perf = get_perf_stats()
        overlapped = bool(self._pending)
        t0 = time.perf_counter()
        sampled = from_host(tick.host, tick.event)
        perf.record_metric("engine.async_pull", (time.perf_counter() - t0) * 1e3, "ms")
        decode_out, prefill_out = self._results
        produced = 0
        for sid, lane in tick.decode:
            pre = tick.ffwd.get(sid, [])
            self._dec_inflight(sid, 1 + len(pre))
            s = eng.sequences.get(sid)
            if s is None or s.done:
                # The row finished at an earlier commit (or was dropped)
                # while this tick was in flight: its tokens are discarded;
                # the finish already rolled its booking back.
                obs.ASYNC_OVERSHOOT_TOKENS.inc(1 + len(pre))
                continue
            dspan = s.decode_span
            accepted = 0
            # The forced tokens precede the sampled one in the append, so
            # the EOS and stop scan sees them in order and a stop inside the
            # run discards its tail as overshoot.
            for tok in list(pre) + [int(sampled[lane])]:
                if s.done:
                    obs.ASYNC_OVERSHOOT_TOKENS.inc()
                    continue
                eng._accept_token(s, tok)
                decode_out.setdefault(sid, []).append(tok)
                accepted += 1
            produced += accepted
            if dspan is not None:
                dspan.child("ffwd_step" if pre else "mixed_step", tick.t_disp,
                            time.perf_counter(), tokens=accepted)
            if s.done:
                # Roll the bookings (the lookahead tokens' too) back to what
                # was written; the stale writes of ticks still in flight land
                # before any new owner's (stream order).
                eng.alloc.truncate(sid, eng._host_written(s))
        for sid, lane, done, c, finishing in tick.chunks:
            seq = eng.sequences.get(sid)
            if seq is None:
                # Dropped by a failure path while this tick was in flight.
                if finishing:
                    self._finishing.discard(sid)
                    self._dec_inflight(sid)
                continue
            if not finishing:
                prefill_out[sid] = False
                continue
            # The finishing chunk: the prompt's first token.
            self._finishing.discard(sid)
            self._dec_inflight(sid)
            eng._prefilling.pop(sid, None)
            seq.ttft_s = time.perf_counter() - seq.started_s
            perf.record_metric("engine.ttft", seq.ttft_s * 1e3, "ms")
            eng._first_token_obs(seq)
            eng._accept_token(seq, int(sampled[lane]))
            prefill_out[sid] = True
            if seq.done:
                eng.alloc.truncate(sid, eng._host_written(seq))
        if produced:
            perf.record_metric("engine.decode_tokens", produced, "tok")
        record_async_commit(overlapped, len(self._pending))
        eng._observe_occupancy()
