"""Continuous-batching scheduler (the port's counterpart of
``opsagent_tpu/serving/scheduler.py``, without its restart recovery,
class-fair admission and offload parking).

One thread owns the engine. Each tick admits waiting requests while batch
slots and pages allow, then runs ONE device program: a mixed step when a
prompt is admitting (every decode lane plus prefill chunks under the
``max_step_tokens`` budget), else a decode block. Finished sequences release
their pages at once, so queued requests enter mid-flight.

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
from dataclasses import dataclass, field
from typing import Any, Callable

from .. import obs
from ..utils import profiling
from ..utils.perf import get_perf_stats
from .engine import Engine, MaskFn
from .kvcache import InvalidRequest, OutOfPages, PromptTooLong
from .sampler import SamplingParams

log = logging.getLogger("opsagent_tpu_torch.scheduler")

# A request still waiting for a batch slot after this long fails with 503.
ADMISSION_TIMEOUT_S = 120.0


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
    # Observability: the request's span handle (obs.trace.Span), under
    # which the scheduler records queue_wait and the engine the prefill
    # and decode phases.
    trace: Any = None


class Scheduler:
    def __init__(self, engine: Engine):
        self.engine = engine
        self._queue: "queue.Queue[Request]" = queue.Queue()
        self._waiting: list[Request] = []
        self._prefilling: dict[int, Request] = {}  # admitted, chunks pending
        self._running: dict[int, Request] = {}
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: threading.Thread | None = None

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

    # -- loop --------------------------------------------------------------
    def _try_admit(self) -> None:
        """Move waiting requests into the prefilling state while batch slots
        and pages allow (page allocation only; the device work runs in
        mixed steps)."""
        while True:
            try:
                self._waiting.append(self._queue.get_nowait())
            except queue.Empty:
                break
        still: list[Request] = []
        now = time.perf_counter()
        for req in self._waiting:
            occupied = len(self._running) + len(self._prefilling)
            if occupied >= self.engine.cfg.max_batch_size:
                still.append(req)
                continue
            if now - req.enqueued_s > ADMISSION_TIMEOUT_S:
                error = "admission timed out (engine saturated)"
                self._count(req, "timeout")
                obs.flight.anomaly(
                    "request_error", error=error,
                    request_id=obs.flight.request_id_of(req.trace),
                )
                self._fail(req, error, 503)
                continue
            try:
                seq_id = self.engine.begin_request(
                    req.prompt_ids, req.sampling, req.mask_fn, req.on_token,
                    trace=req.trace,
                )
            except OutOfPages:
                still.append(req)  # pages free as running sequences finish
                continue
            except (PromptTooLong, InvalidRequest) as e:
                self._fail(req, f"admission failed: {e}", 400)
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

    def _mixed_tick(self) -> bool:
        """One mixed step: every running decode lane advances a token and
        the oldest admitting prompts get chunks from what is left of the
        ``max_step_tokens`` budget. Returns False when nothing is
        admitting (the tick goes to block decode)."""
        eng = self.engine
        if not self._prefilling:
            return False
        decode_ids = sorted(
            sid for sid in self._running if not eng.sequences[sid].done
        )
        budget = eng.cfg.max_step_tokens - len(decode_ids)
        rows_left = eng.cfg.max_batch_size - len(decode_ids)
        cap = eng.cfg.mixed_buckets[-1]
        chunks: dict[int, int] = {}
        for sid in self._prefilling:  # admission order: oldest first
            if budget <= 0 or rows_left <= 0:
                break
            done, total = eng.prefill_progress(sid)
            c = min(total - done, budget, cap)
            chunks[sid] = c
            budget -= c
            rows_left -= 1
        if not chunks:
            return False
        try:
            _, prefill_out = eng.step_mixed(decode_ids, chunks)
        except Exception as e:
            for sid in chunks:  # the engine dropped these admissions
                req = self._prefilling.pop(sid)
                self._count(req, "admission_failed")
                obs.flight.anomaly(
                    "request_error", seq_id=sid, error=str(e),
                    request_id=obs.flight.request_id_of(req.trace),
                )
                self._fail(req, f"admission failed: {e}")
            raise
        for sid, prompt_done in prefill_out.items():
            if prompt_done:
                req = self._prefilling.pop(sid)
                # Time to first token as the client sees it: from submission.
                req.ttft_s = time.perf_counter() - req.enqueued_s
                self._running[sid] = req
        return True

    def _reap(self) -> None:
        for sid in [s for s in self._running if self.engine.sequences[s].done]:
            req = self._running.pop(sid)
            seq = self.engine.sequences[sid]
            req.finish_reason = seq.finish_reason
            req.logprob_data = list(seq.logprob_data)
            req.tokens = self.engine.finish(sid)
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

    def _loop(self) -> None:
        profiling.host_captures()
        try:
            self._serve()
        finally:
            profiling.release_captures()

    def _serve(self) -> None:
        while not self._stop.is_set():
            profiling.service()
            try:
                self._try_admit()
                if not self._mixed_tick() and self._running:
                    self.engine.step_block(sorted(self._running))
                self._reap()
                if not self._running and not self._prefilling:
                    # Idle: the wait must not be observed as a host gap.
                    self.engine.mixed_gap_break()
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
            except Exception as e:  # noqa: BLE001 - the loop must survive
                log.exception("scheduler step failed")
                obs.flight.anomaly(
                    "request_error", error=f"engine step failed: {e}",
                    failed_requests=len(self._running),
                )
                for sid, req in list(self._running.items()):
                    req.tokens = self.engine.finish(sid)
                    self._fail(req, f"engine step failed: {e}")
                self._running.clear()
        while not self._queue.empty():
            self._waiting.append(self._queue.get_nowait())
        for req in self._waiting:
            self._fail(req, "scheduler stopped")
        for sid, req in list(self._prefilling.items()):
            self.engine.abort_request(sid)
            self._fail(req, "scheduler stopped")
        for sid, req in list(self._running.items()):
            req.tokens = self.engine.finish(sid)
            self._fail(req, "scheduler stopped")
        self._prefilling.clear()
        self._running.clear()
