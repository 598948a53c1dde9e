"""Continuous-batching scheduler (the port's counterpart of
``opsagent_tpu/serving/scheduler.py``).

One thread owns the engine. Each tick admits waiting requests while batch
slots and pages allow, class-fair (interactive before batch before
background, arrival order within a class), then routes the tick as the JAX
scheduler does:

1. the async lane (``EngineConfig.async_depth`` > 1): an async mixed tick
   when a prompt is admitting, ticks are in flight, or a running row on
   the device FSM tables can fast-forward; a hosted row, or two schemas,
   settle it and pass the tick on;
2. grammar fast-forward on the running rows the async lane left;
3. a synchronous mixed tick when a prompt is admitting (every decode lane
   plus prefill chunks under the ``max_step_tokens`` budget);
4. else the split prefill lane when a prompt is admitting
   (``_advance_prefill``: one chunk batch through ``Engine.prefill_batch``;
   every admission with ``EngineConfig.mixed_batching`` off, which also
   turns lanes 1-3 off), then a decode block (pipelined at
   ``pipeline_depth`` > 0).

The JAX scheduler also sends a tick with a hosted constrained row, a
logprobs row or a biased row to the split lane; the port's mixed ticks seat
those rows (their graphs carry the mask and the sampler extras), so they
stay on lane 3.

Finished sequences release their pages at once, so queued requests enter
mid-flight. With the engine's host KV tier, an admission that finds no
pages parks the coldest running session (``_park_coldest``: its pages
copied to host RAM, its request re-queued with its tokens folded into the
prompt) and retries once; the parked request's re-admission restores its
pages instead of re-prefilling them. Idle ticks land pending page copies
(``Engine.offload_flush``).

A failing step is first reaped (a raising stream callback or mask ends its
own request only); the batch fails only after 3 consecutive failures that
no request accounts for. With an ``engine_factory`` the scheduler then
rebuilds the engine (warmed up before any re-admission) and re-admits
every request in flight with the tokens it has so far, up to
``max_restarts`` times (``_recover``); a request that fails keeps its
``generated_prefix``.

A fleet drain (``drain_for_migration``) stops the loop without failing
anything: it settles the engine's ticks and blocks in flight, parks every
running session's pages to the host tier, and hands every request that
still needs tokens back with its salvage folded in (``_requeue_salvaged``,
the restart flow), for another replica's scheduler to admit.

Fault points (``serving/faults.py``): ``sched.out_of_pages`` at each
admission attempt and ``sched.step_fault`` once a tick with work in flight,
as in the JAX scheduler.

A request's ``mask_fn`` constrains its tokens (``serving.constrained``); a
mask that raises on admission fails the request with 400. A request that
asks for logprobs gets them in ``logprob_data`` when it finishes. Its
``on_token`` receives each accepted token on the scheduler thread, after
each mixed tick and each block's pull (a block's tokens arrive together).

Observability at the JAX scheduler's points: a request's span handle rides
its ``Request`` (``trace``; the scheduler thread has no ambient context)
into ``Engine.begin_request``; admission records the ``queue_wait`` span,
``opsagent_queue_wait_seconds`` and queued goodput; each request's end
counts ``opsagent_engine_requests_total{outcome}`` and the per-class
``opsagent_class_requests_total``, and a failed one is a flight anomaly.
The loop hosts the profiler's captures (``utils.profiling``), so a
``/api/debug/profile`` trace holds the engine's ticks.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass, field, replace
from typing import Any, Callable

from .. import obs
from ..utils import profiling
from . import faults
from ..utils.perf import get_perf_stats
from .engine import Engine, MaskFn
from .kvcache import InvalidRequest, OutOfPages, PromptTooLong
from .sampler import SamplingParams

log = logging.getLogger("opsagent_tpu_torch.scheduler")

# Admission precedence by SLO class, lower first; an unclassed request ranks
# as interactive.
_CLASS_ADMIT_RANK = {"interactive": 0, "batch": 1, "background": 2}
# Consecutive step failures no request accounts for before the batch fails
# (or, with an engine factory, the engine is rebuilt).
FAILURES_BEFORE_RECOVERY = 3


class RequestError(RuntimeError):
    """A failed request with an HTTP status (400: the request can never
    succeed; 500: engine-side failure)."""

    def __init__(self, message: str, status: int = 500):
        super().__init__(message)
        self.status = status


@dataclass
class Request:
    prompt_ids: list[int]
    sampling: SamplingParams
    mask_fn: MaskFn | None = None
    on_token: Callable[[int], None] | None = None
    # filled by the scheduler:
    seq_id: int | None = None
    tokens: list[int] = field(default_factory=list)
    # Per-token logprob entries (the engine's Sequence.logprob_data), when
    # sampling.logprobs asked for them.
    logprob_data: list[dict] = field(default_factory=list)
    finish_reason: str = ""
    error: str = ""
    error_status: int = 500
    ttft_s: float = 0.0
    enqueued_s: float = field(default_factory=time.perf_counter)
    done: threading.Event = field(default_factory=threading.Event)
    # Tokens generated before an engine restart: the re-admission folds them
    # into the prompt, and the result is generated_prefix + what follows.
    # A stream has had them already and is not sent them again.
    generated_prefix: list[int] = field(default_factory=list)
    # Pressure-parked to the host KV tier: the re-admission is expected to
    # restore its pages, and one that re-prefills instead is an anomaly.
    parked: bool = False
    # Observability: the request's span handle (obs.trace.Span), under
    # which the scheduler records queue_wait and the engine the prefill
    # and decode phases.
    trace: Any = None


def _admit_rank(req: Request) -> int:
    return _CLASS_ADMIT_RANK.get(obs.trace.class_of(req.trace, "interactive"), 0)


class Scheduler:
    def __init__(
        self,
        engine: Engine,
        admission_timeout_s: float = 120.0,
        engine_factory: Callable[[], Engine] | None = None,
        max_restarts: int = 3,
    ):
        """``admission_timeout_s``: a request still waiting for a batch slot
        after this long fails with 503. ``engine_factory``: how to rebuild
        the engine when it fails persistently, at most ``max_restarts``
        times; without one, persistent failure fails the requests in
        flight."""
        self.engine = engine
        self.admission_timeout_s = admission_timeout_s
        self._engine_factory = engine_factory
        self._max_restarts = max_restarts
        self._restarts = 0
        self._queue: "queue.Queue[Request]" = queue.Queue()
        self._waiting: list[Request] = []
        self._prefilling: dict[int, Request] = {}  # admitted, chunks pending
        self._running: dict[int, Request] = {}
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: threading.Thread | None = None
        # Fleet drain: the loop exits without failing the requests in
        # flight; drain_for_migration() parks and returns them.
        self._draining = False

    # -- public ------------------------------------------------------------
    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    def submit(self, req: Request) -> Request:
        self._queue.put(req)
        self._wake.set()
        return req

    def drain_for_migration(self) -> list[Request]:
        """Fleet drain (``serving/fleet``): stop the loop without failing
        anything, park every running session's KV to the host tier, and
        return every request that still needs tokens, for the fleet router
        to admit on another replica. No token is lost or repeated: a
        running request's generated tokens fold into its prompt
        (``_requeue_salvaged``: budget, penalties, constraint and stream
        carried on), so the admission elsewhere continues where this
        replica stopped. Requests that finish while the engine settles are
        reaped here with their full result. Without the host tier the
        salvage still folds in and the target re-prefills it."""
        self._draining = True
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        eng = self.engine
        out: list[Request] = []
        self._drain_queue()
        # Settle the ticks and blocks in flight: their tokens land in the
        # sequences, and finished admissions move to running.
        _, p_out = eng.async_drain()
        self._fold_prefill(p_out)
        with eng.lock:
            eng.drain()
            eng._flush_and_invalidate()
        for sid, req in list(self._running.items()):
            parked = None
            if eng.offload is not None:
                try:
                    parked = eng.park_sequence(sid)
                except Exception:  # noqa: BLE001 - falls back to the salvage
                    log.exception("drain parking of seq %d failed", sid)
            if parked is not None:
                self._running.pop(sid)
                if self._requeue_salvaged(req, parked.tokens, parked.logprob_data,
                                          parked=True):
                    out.append(req)
                continue
            seq = eng.sequences.get(sid)
            if seq is not None and seq.done:
                continue  # reaped below with its full result
            partial: list[int] = []
            lp: list[dict] = list(seq.logprob_data) if seq is not None else []
            try:
                partial = eng.finish(sid)
            except Exception:  # noqa: BLE001 - device state may be gone
                pass
            self._running.pop(sid, None)
            if self._requeue_salvaged(req, partial, lp):
                out.append(req)
        self._reap()
        for sid, req in list(self._prefilling.items()):
            try:
                eng.abort_request(sid)
            except Exception:  # noqa: BLE001
                pass
            req.seq_id = None
            req.enqueued_s = time.perf_counter()
            out.append(req)
        self._prefilling.clear()
        out.extend(self._waiting)
        self._waiting = []
        try:
            eng.offload_flush()  # land the parked pages in the host pool
        except Exception:  # noqa: BLE001 - best-effort
            log.exception("offload flush after a drain failed")
        return out

    # -- loop --------------------------------------------------------------
    def _try_admit(self) -> None:
        """Move waiting requests into the prefilling state while batch slots
        and pages allow (page allocation only; the device work runs in
        mixed steps). Class-fair: the waiting list is sorted stably by SLO
        class first, so an interactive request queued behind a batch
        fan-out is admitted ahead of it."""
        self._drain_queue()
        if len(self._waiting) > 1:
            self._waiting.sort(key=_admit_rank)
        still: list[Request] = []
        now = time.perf_counter()
        for req in self._waiting:
            occupied = len(self._running) + len(self._prefilling)
            if occupied >= self.engine.cfg.max_batch_size:
                still.append(req)
                continue
            if now - req.enqueued_s > self.admission_timeout_s:
                error = "admission timed out (engine saturated)"
                self._count(req, "timeout")
                obs.flight.anomaly(
                    "request_error", error=error,
                    request_id=obs.flight.request_id_of(req.trace),
                )
                self._fail(req, error, 503)
                continue
            try:
                try:
                    seq_id = self._begin(req)
                except OutOfPages:
                    # Park the coldest running session to host RAM rather
                    # than queue behind the pages it pins, and retry once.
                    if not self._park_coldest():
                        raise
                    seq_id = self._begin(req)
            except OutOfPages:
                still.append(req)  # pages free as running sequences finish
                continue
            except (PromptTooLong, InvalidRequest) as e:
                self._fail(req, f"admission failed: {e}", 400)
                continue
            except Exception as e:  # noqa: BLE001 - surfaced on the request
                self._fail(req, f"admission failed: {e}")
                continue
            req.seq_id = seq_id
            self._prefilling[seq_id] = req
            wait_s = now - req.enqueued_s
            get_perf_stats().record_metric("scheduler.queue_wait", wait_s * 1e3, "ms")
            obs.QUEUE_WAIT_SECONDS.observe(wait_s)
            obs.attribution.record_goodput(
                wait_s, "queued", slo_class=obs.trace.class_of(req.trace)
            )
            if req.trace is not None:
                req.trace.child("queue_wait", req.enqueued_s, now)
        self._waiting = still

    def _begin(self, req: Request) -> int:
        faults.maybe_raise("sched.out_of_pages", OutOfPages, "injected OutOfPages storm")
        return self.engine.begin_request(
            req.prompt_ids, req.sampling, req.mask_fn, req.on_token,
            trace=req.trace, expect_restore=req.parked,
        )

    def _park_coldest(self) -> bool:
        """Pressure parking (host KV tier): park the running session that
        produced a token least recently (``Engine.park_sequence``) and
        re-queue its request with the salvage folded in, at the back of
        the queue, so that the prompt the parking made room for admits
        first. Returns True when a session was parked."""
        eng = self.engine
        if eng.offload is None or not self._running:
            return False
        best: tuple[float, int] | None = None
        for sid in self._running:
            seq = eng.sequences.get(sid)
            if seq is None or seq.done:
                continue
            last = seq.last_tok_s or seq.started_s
            if best is None or last < best[0]:
                best = (last, sid)
        if best is None:
            return False
        sid = best[1]
        try:
            parked = eng.park_sequence(sid)
        except Exception:  # noqa: BLE001 - parking is best-effort
            log.exception("pressure parking of seq %d failed", sid)
            return False
        if parked is None:
            return False  # it finished while the pipelines settled: reap it
        req = self._running.pop(sid)
        if self._requeue_salvaged(req, parked.tokens, parked.logprob_data, parked=True):
            self._waiting.append(req)
        return True

    def _drain_queue(self) -> None:
        while True:
            try:
                self._waiting.append(self._queue.get_nowait())
            except queue.Empty:
                return

    def _chunks(self, decode_ids: list[int]) -> dict[int, int]:
        """Prefill chunks for the oldest admitting prompts from what the
        decode lanes leave of the ``max_step_tokens`` budget and the batch."""
        eng = self.engine
        budget = eng.cfg.max_step_tokens - len(decode_ids)
        rows_left = eng.cfg.max_batch_size - len(decode_ids)
        cap = eng.cfg.mixed_buckets[-1]
        chunks: dict[int, int] = {}
        for sid in self._prefilling:  # admission order: oldest first
            if budget <= 0 or rows_left <= 0:
                break
            try:
                # With async ticks this is planned progress: chunks in
                # flight count as done, so a prompt is never offered twice.
                done, total = eng.prefill_progress(sid)
            except KeyError:
                continue  # its last chunk is in flight, or it failed
            c = min(total - done, budget, cap)
            if c <= 0:
                continue
            chunks[sid] = c
            budget -= c
            rows_left -= 1
        return chunks

    def _decode_ids(self) -> list[int]:
        eng = self.engine
        return sorted(sid for sid in self._running
                      if sid in eng.sequences and not eng.sequences[sid].done)

    def _mixed_tick(self) -> bool:
        """The tick's mixed lanes, in the JAX scheduler's order: the async
        lane, then grammar fast-forward on the running rows it left, then
        one synchronous mixed step (every decode lane plus chunks of the
        oldest admitting prompts). Returns False when no mixed step ran
        and the tick goes to block decode."""
        eng = self.engine
        if not eng.cfg.mixed_batching:
            return False
        if eng.cfg.async_depth > 1 and self._async_mixed_tick():
            return True
        if eng.cfg.grammar_ffwd and self._running:
            eng.ffwd_step(sorted(self._running))
        if not self._prefilling:
            return False
        decode_ids = self._decode_ids()
        chunks = self._chunks(decode_ids)
        if not chunks:
            return False
        try:
            _, prefill_out = eng.step_mixed(decode_ids, chunks)
        except Exception as e:
            # The engine dropped these admissions; fail them, then let the
            # loop's failure accounting see the error.
            for sid in chunks:
                self._fail_admission(sid, e)
            raise
        self._fold_prefill(prefill_out)
        return True

    def _advance_prefill(self) -> None:
        """The split prefill lane (JAX's ``_advance_prefill``): one chunk for
        a batch of admitting requests, the oldest plus up to
        ``prefill_batch`` - 1 more whose next chunk pads to the same bucket,
        in one dispatch (``Engine.prefill_batch``). One chunk batch a tick:
        long prompts interleave with decode blocks, and concurrent
        admissions share dispatches."""
        if not self._prefilling:
            return
        eng = self.engine
        first = next(iter(self._prefilling))
        batch = [first]
        try:
            bucket = eng.next_prefill_bucket(first)
            for sid in self._prefilling:
                if len(batch) >= min(eng.cfg.prefill_batch, eng.cfg.max_batch_size):
                    break
                if sid != first and eng.next_prefill_bucket(sid) == bucket:
                    batch.append(sid)
            results = eng.prefill_batch(batch)
        except Exception as e:  # noqa: BLE001 - the engine dropped the rows
            for sid in batch:
                self._fail_admission(sid, e)
            return
        for sid, res in results.items():
            if isinstance(res, Exception):
                # A row-local failure (its mask_fn or stream callback
                # raised): only this request fails.
                self._fail_admission(sid, res)
            elif res:
                self._fold_prefill({sid: True})

    def _fold_prefill(self, prefill_out: dict[int, bool]) -> None:
        """Completed prompts move to running (False: more chunks to go)."""
        for sid, prompt_done in prefill_out.items():
            if prompt_done:
                req = self._prefilling.pop(sid, None)
                if req is not None:
                    # Time to first token as the client sees it.
                    req.ttft_s = time.perf_counter() - req.enqueued_s
                    self._running[sid] = req

    def _async_mixed_tick(self) -> bool:
        """The one-tick-lookahead mixed tick (``async_depth`` > 1): tick t+1
        is planned and enqueued before tick t's tokens are pulled, so the
        host work between enqueues overlaps the card. Results lag by up to
        depth - 1 ticks; admissions are folded in whenever they surface.
        Returns True when the async lane took the tick (an enqueue or a
        settle); False routes it to the sync lanes: nothing admitting,
        nothing in flight and no row to fast-forward (pure decode belongs
        to the blocks), or a row needing a hosted lane."""
        eng = self.engine
        _, p_out = eng.async_take_results()
        self._fold_prefill(p_out)
        # Fast-forward keeps device-table constrained rows on the async
        # lane even in pure decode: its planner appends forced runs at
        # every enqueue, which the pipelined blocks (host tokens behind the
        # blocks in flight) cannot.
        ffwd_decode = eng.cfg.grammar_ffwd and any(
            sid in eng.sequences and not eng.sequences[sid].done
            and eng.async_row_fsm(sid) is not None
            for sid in self._running
        )
        if not self._prefilling and not eng.async_pending() and not ffwd_decode:
            return False
        # Hosted rows and ticks of two schemas take the sync lanes: settle
        # the pipeline first so that they see the current host state.
        fsm_seen = None
        for sid in list(self._running) + list(self._prefilling):
            hosted = eng.mixed_async_hosted(sid)
            mismatch = False
            if not hosted:
                f = eng.async_row_fsm(sid)
                if f is not None:
                    mismatch = fsm_seen is not None and f is not fsm_seen
                    fsm_seen = f
            if hosted or mismatch:
                obs.ASYNC_FALLBACKS.inc(reason="hosted" if hosted else "fsm_mismatch")
                if hosted and eng.cfg.grammar_ffwd:
                    # It cannot fast-forward either (counted once a row).
                    eng.note_ffwd_ineligible(sid)
                _, p_out = eng.async_drain()
                self._fold_prefill(p_out)
                return False
        decode_ids = self._decode_ids()
        chunks = self._chunks(decode_ids)
        if not chunks:
            if not ffwd_decode:
                if not eng.async_pending():
                    return False
                # Every admitting prompt is planned and only commits
                # remain: settle, and the next tick decodes in blocks.
                _, p_out = eng.async_drain()
                self._fold_prefill(p_out)
                return True
            if not decode_ids:
                return False
        try:
            _, p_out = eng.step_mixed_async(decode_ids, chunks)
        except Exception as e:
            # The engine dropped this tick's admissions (the earlier ticks
            # were salvaged); fail them, then let the loop account for it.
            for sid in chunks:
                self._fail_admission(sid, e)
            raise
        self._fold_prefill(p_out)
        return True

    def _fail_admission(self, sid: int, e: Exception) -> None:
        req = self._prefilling.pop(sid, None)
        if req is None:
            return
        self._count(req, "admission_failed")
        obs.flight.anomaly(
            "request_error", seq_id=sid, error=str(e),
            request_id=obs.flight.request_id_of(req.trace),
        )
        self._fail(req, f"admission failed: {e}",
                   400 if isinstance(e, (InvalidRequest, PromptTooLong)) else 500)

    def _reap(self) -> None:
        for sid in [s for s in self._running if self.engine.sequences[s].done]:
            req = self._running.pop(sid)
            seq = self.engine.sequences[sid]
            req.finish_reason = seq.finish_reason
            req.logprob_data = req.logprob_data + seq.logprob_data
            req.tokens = req.generated_prefix + self.engine.finish(sid)
            if req.finish_reason == "error":
                # Its mask or stream callback raised (logged by the engine).
                req.error = "constrained decoding or streaming failed"
            self._count(req, "error" if req.error else "completed")
            if req.error:
                obs.flight.anomaly(
                    "request_error", seq_id=sid, error=req.error,
                    request_id=obs.flight.request_id_of(req.trace),
                )
            req.done.set()

    @staticmethod
    def _fail(req: Request, message: str, status: int = 500) -> None:
        req.error, req.error_status = message, status
        req.done.set()

    @staticmethod
    def _count(req: Request, outcome: str) -> None:
        """A request's end: ``opsagent_engine_requests_total{outcome}`` and
        the per-class ``opsagent_class_requests_total``."""
        obs.ENGINE_REQUESTS.inc(outcome=outcome)
        obs.CLASS_REQUESTS.inc(**{
            "class": obs.trace.class_of(req.trace, "interactive"),
            "outcome": outcome,
        })

    def _requeue_salvaged(
        self, req: Request, partial: list[int], logprob_data: list[dict],
        parked: bool = False,
    ) -> bool:
        """Fold a salvaged generation into the request so that its
        re-admission continues where it stopped: prompt += salvage, budget
        -= salvage, the penalties count the salvage as output, a constraint
        walks on from where it was, and a stream is not sent the salvage
        again. Shared by engine restarts and pressure parking (``parked``).
        Returns False when the budget is spent (the request is then
        finished, not re-queued)."""
        req.logprob_data = req.logprob_data + logprob_data[: len(partial)]
        req.generated_prefix = req.generated_prefix + partial
        # sampling.max_tokens is already less the earlier salvages.
        budget = req.sampling.max_tokens - len(partial)
        if budget <= 0:
            req.tokens = req.generated_prefix
            req.finish_reason = "length"
            req.done.set()
            return False
        req.prompt_ids = req.prompt_ids + partial
        req.sampling = replace(
            req.sampling, max_tokens=budget,
            # Folded into the prompt, still counted as output.
            penalty_history=tuple(req.generated_prefix),
        )
        if req.mask_fn is not None and partial:
            # Wrapped with this salvage alone: the inner one prepends the
            # earlier salvages already.
            inner = req.mask_fn
            req.mask_fn = lambda toks, _p=list(partial), _f=inner: _f(_p + toks)
        req.seq_id = None
        req.parked = parked or req.parked
        # Time spent generating does not count against the admission
        # timeout of the re-admission.
        req.enqueued_s = time.perf_counter()
        return True

    def _recover(self) -> None:
        """Rebuild the engine and re-admit every request in flight from the
        host state it keeps: each running sequence's tokens are salvaged
        (``_requeue_salvaged``) and the request re-enters the queue ahead of
        the waiting ones; prefilling requests re-enter whole. The dead
        engine's device buffers are dropped before the factory builds the
        new one, which is warmed up (its graphs captured) before any
        re-admission. A failed rebuild keeps the old engine: admission is
        host-side, so queued work waits for the next attempt."""
        self._restarts += 1
        log.error(
            "engine restart %d/%d: rebuilding, re-admitting %d running + %d "
            "prefilling requests", self._restarts, self._max_restarts,
            len(self._running), len(self._prefilling),
        )
        obs.flight.anomaly(
            "engine_restart", restart=self._restarts, max_restarts=self._max_restarts,
            running=len(self._running), prefilling=len(self._prefilling),
        )
        salvaged: list[Request] = []
        for sid, req in list(self._running.items()):
            partial: list[int] = []
            seq = self.engine.sequences.get(sid)
            try:
                partial = self.engine.finish(sid)
            except Exception:  # noqa: BLE001 - device state may be gone
                pass
            if self._requeue_salvaged(req, partial, seq.logprob_data if seq else []):
                salvaged.append(req)
        self._running.clear()
        for req in self._prefilling.values():
            req.seq_id = None
            req.enqueued_s = time.perf_counter()
            salvaged.append(req)
        self._prefilling.clear()
        self._waiting = salvaged + self._waiting
        dead = self.engine
        for buf in ("model", "cache", "_graphs", "_decode", "_mixed", "_fsm", "_extras"):
            setattr(dead, buf, None)
        try:
            engine = self._engine_factory()
            engine.warmup()
        except Exception:  # noqa: BLE001 - the device may still be coming back
            log.exception("engine rebuild failed; queued work waits for the next attempt")
            return
        self.engine = engine

    def _loop(self) -> None:
        profiling.host_captures()
        try:
            self._serve()
        finally:
            profiling.release_captures()

    def _serve(self) -> None:
        failures = 0
        while not self._stop.is_set():
            profiling.service()
            try:
                self._try_admit()
                if self._running or self._prefilling:
                    # Counted only with work in flight: idle ticks spin at
                    # a rate of their own, which would tie hit-count
                    # selectors to the wall clock.
                    faults.maybe_raise("sched.step_fault", RuntimeError,
                                       "injected scheduler step fault")
                mixed = self._mixed_tick()
                if not mixed:
                    self._advance_prefill()
                self._reap()
                if not self._running:
                    if self._prefilling:
                        continue  # keep admitting
                    # Idle: the wait must not be observed as a host gap.
                    self.engine.mixed_gap_break()
                    # Land pending device->host page copies, then wait.
                    try:
                        self.engine.offload_flush()
                    except Exception:  # noqa: BLE001 - best-effort
                        log.exception("offload flush failed")
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
                    continue
                if not mixed:
                    self.engine.step_block(sorted(self._running))
                    self._reap()
                failures = 0
            except Exception as e:  # noqa: BLE001 - the loop must survive
                log.exception("scheduler step failed")
                # A raising stream callback or mask has ended its own
                # sequence: reaping it is progress, not an engine failure.
                before = len(self._running)
                try:
                    self._reap()
                except Exception:  # noqa: BLE001
                    pass
                if len(self._running) < before:
                    failures = 0
                    continue
                failures += 1
                if failures < FAILURES_BEFORE_RECOVERY:
                    continue
                failures = 0
                if self._engine_factory is not None and self._restarts < self._max_restarts:
                    self._recover()
                    continue
                obs.flight.anomaly(
                    "request_error", error=f"engine failing persistently: {e}",
                    failed_requests=len(self._running),
                )
                for sid, req in list(self._running.items()):
                    # An earlier restart's salvage reached the client
                    # already: it stays in the result.
                    req.tokens = list(req.generated_prefix)
                    try:
                        req.tokens = req.generated_prefix + self.engine.finish(sid)
                    except Exception:  # noqa: BLE001
                        pass
                    self._fail(req, f"engine step failed: {e}")
                self._running.clear()
        if self._draining:
            # Fleet drain: every request in flight stays intact for
            # drain_for_migration() to park and hand over.
            log.info("scheduler loop stopped for a drain (%d running, %d prefilling, "
                     "%d waiting)", len(self._running), len(self._prefilling),
                     len(self._waiting))
            return
        self._drain_queue()
        for req in self._waiting:
            self._fail(req, "scheduler stopped")
        for sid, req in list(self._prefilling.items()):
            self.engine.abort_request(sid)
            self._fail(req, "scheduler stopped")
        for sid, req in list(self._running.items()):
            req.tokens = req.generated_prefix + self.engine.finish(sid)
            self._fail(req, "scheduler stopped")
        self._prefilling.clear()
        self._running.clear()
