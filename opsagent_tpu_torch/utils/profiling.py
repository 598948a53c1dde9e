"""Device-level profiling: ``torch.profiler`` traces and per-step device
timings, layered on the request-level perf registry (the port's
counterpart of ``opsagent_tpu/utils/profiling.py``).

Host wall-clock around a step measures the host's view of it; where the
time goes on the card needs the device's own clock. Two views:

1. **Traces** — ``trace()`` and ``timed_capture()`` run a
   ``torch.profiler`` capture (CPU and CUDA activities) and write a Chrome
   trace (``chrome://tracing`` / Perfetto: per-kernel device timelines
   beside the host's ops and annotations) into ``OPSAGENT_PROFILE_DIR``
   or an explicit ``logdir``. ``trace`` is a no-op without either, so
   production serving pays nothing.
2. **Per-step device timings** — ``device_timer()`` records a step's
   device time into the perf registry under a ``device.`` prefix, timed
   with CUDA events on the current stream; opt-in via
   ``OPSAGENT_DEVICE_TIMING=1``, since reading the end event waits for the
   step.

``annotate()`` names a host region on the profiler timeline
(``torch.profiler.record_function``) and as an NVTX range; it costs one
check when no capture runs. ``save_device_memory_profile()`` writes the
caching allocator's snapshot for PyTorch's memory viewer.

A capture runs on one host thread (torch.profiler records the host ops of
the thread that starts it): the serving loop where one runs, so the trace
holds the engine's ticks and annotations (see ``host_captures``). It never
starts inside a CUDA-graph capture: the serving steps are captured by
``Engine.warmup`` before the server starts, and a profile only runs in its
window.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import threading
import time
from typing import Any, Iterator

import torch

from .logger import get_logger
from .perf import get_perf_stats

log = get_logger("profiling")

_ENV_DIR = "OPSAGENT_PROFILE_DIR"
_ENV_TIMING = "OPSAGENT_DEVICE_TIMING"

MAX_CAPTURE_SECONDS = 120.0

def profile_dir() -> str | None:
    """The configured trace directory, or None when tracing is off."""
    return os.environ.get(_ENV_DIR) or None


def device_timing_enabled() -> bool:
    return os.environ.get(_ENV_TIMING, "") not in ("", "0", "false")


def _activities() -> list[torch.profiler.ProfilerActivity]:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


# -- captures, run on a host thread ----------------------------------------
# torch.profiler records the host ops and annotations of the thread that
# started it, and it must stop on that thread. A capture therefore runs on
# one host thread, whoever asks for it: the serving loop (the scheduler
# thread, which runs the engine; ``host_captures``) polls ``service`` once
# per iteration, so the trace holds its ticks; with no such host, a private
# thread hosts the capture and the trace holds the device's kernels alone.
HOST_WAIT_S = 30.0


class _Capture:
    def __init__(self, logdir: str, host: threading.Thread | None):
        self.logdir = logdir
        self.host = host
        self.prof: torch.profiler.profile | None = None
        self.stop = False
        self.error: Exception | None = None
        self.started = threading.Event()
        self.done = threading.Event()


_lock = threading.Lock()
_host: threading.Thread | None = None
_capture: _Capture | None = None


def host_captures() -> None:
    """Make the calling thread the one captures run on. It must call
    ``service`` often and ``release_captures`` when it ends."""
    global _host
    with _lock:
        _host = threading.current_thread()


def release_captures() -> None:
    """The host thread ends: its running capture is stopped and written."""
    global _host
    service(final=True)
    with _lock:
        if _host is threading.current_thread():
            _host = None


def service(final: bool = False) -> None:
    """On the host thread: start the capture asked for, or stop the one
    asked to stop (any with ``final``); the asker writes the trace, so the
    serving loop does not wait for it. One check when no capture is asked
    for."""
    global _capture
    cap = _capture
    if cap is None or cap.host is not threading.current_thread():
        return
    if cap.prof is None and not (cap.stop or final):
        try:
            cap.prof = torch.profiler.profile(activities=_activities())
            cap.prof.start()
        except Exception as e:  # noqa: BLE001 - surfaced to the asker
            cap.error, cap.stop, cap.prof = e, True, None
        cap.started.set()
    if not (cap.stop or final):
        return
    if cap.prof is not None:
        try:
            cap.prof.stop()
        except Exception as e:  # noqa: BLE001 - surfaced to the asker
            cap.error = e
    elif cap.error is None:
        cap.error = RuntimeError("the capture's host thread ended before it started")
    with _lock:
        if _capture is cap:
            _capture = None
    cap.started.set()
    cap.done.set()


def _private_host(cap: _Capture) -> None:
    while not cap.done.is_set():
        service()
        time.sleep(0.01)


def start_trace(logdir: str) -> None:
    """Start a capture that ``stop_trace`` writes into ``logdir``, on the
    host thread; returns once it runs. Raises RuntimeError when one is
    already running (or its host does not start it)."""
    global _capture
    with _lock:
        if _capture is not None:
            raise RuntimeError("a profile capture is already running")
        os.makedirs(logdir, exist_ok=True)
        cap = _capture = _Capture(logdir, _host)
    if cap.host is None:
        cap.host = threading.Thread(target=_private_host, args=(cap,), daemon=True,
                                    name="profile-capture")
        cap.host.start()
    if not cap.started.wait(HOST_WAIT_S):
        cap.stop = True
        with _lock:
            if _capture is cap:
                _capture = None
        raise RuntimeError("the capture's host thread did not start it")
    if cap.error is not None:
        raise RuntimeError(f"profile capture failed: {cap.error}")


def stop_trace() -> str:
    """Stop the running capture and write its Chrome trace; returns the
    file's path. Raises RuntimeError when none is running."""
    with _lock:
        cap = _capture
        if cap is None or cap.prof is None:
            raise RuntimeError("no profile capture is running")
        cap.stop = True
    if not cap.done.wait(HOST_WAIT_S):
        raise RuntimeError("the capture's host thread did not stop it")
    if cap.error is not None:
        raise RuntimeError(f"profile capture failed: {cap.error}")
    stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
    path = os.path.join(cap.logdir, f"trace-{stamp}-{os.getpid()}-{time.monotonic_ns()}.json")
    cap.prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(logdir: str | None = None) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the enclosed region into
    ``logdir`` (or ``$OPSAGENT_PROFILE_DIR``). No-op when neither is set."""
    logdir = logdir or profile_dir()
    if not logdir:
        yield
        return
    start_trace(logdir)
    log.info(f"torch.profiler trace started -> {logdir}")
    try:
        yield
    finally:
        path = stop_trace()
        log.info(f"torch.profiler trace written -> {path}")


class _Annotation:
    """``torch.profiler.record_function`` while a capture runs, plus an
    NVTX range on a CUDA build; nothing else."""

    __slots__ = ("name", "_rf", "_nvtx")

    def __init__(self, name: str):
        self.name = name
        self._rf = None
        self._nvtx = False

    def __enter__(self) -> "_Annotation":
        if torch.autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        if _nvtx_ready():
            torch.cuda.nvtx.range_push(self.name)
            self._nvtx = True
        return self

    def __exit__(self, *exc: Any) -> None:
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)


def _nvtx_ready() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


def annotate(name: str) -> contextlib.AbstractContextManager:
    """Name a host region on the profiler timeline and as an NVTX range.
    Safe to leave in the hot path: one check when nothing captures."""
    return _Annotation(name)


@contextlib.contextmanager
def device_timer(name: str, outputs: list[Any]) -> Iterator[None]:
    """Measure the device time of one step.

    The body appends the step's output tensors to ``outputs``. When
    ``OPSAGENT_DEVICE_TIMING`` is set: on a CUDA device, CUDA events
    recorded on the current stream before and after the body bound the
    step, and the end event is waited for (not the whole device); on the
    CPU the body's wall time is the step's. The time lands in the perf
    registry as ``device.<name>``. Unset, this is a plain pass-through."""
    if not device_timing_enabled():
        yield
        return
    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    if cuda:
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
    w0 = time.perf_counter()
    yield
    on_card = cuda and any(
        isinstance(o, torch.Tensor) and o.is_cuda for o in outputs
    )
    if on_card:
        t1.record()
        t1.synchronize()
        ms = t0.elapsed_time(t1)
    else:
        ms = (time.perf_counter() - w0) * 1e3
    get_perf_stats().record_metric(f"device.{name}", ms, "ms")


class ProfilingDisabled(RuntimeError):
    """No trace directory is configured."""


def timed_capture(seconds: float, logdir: str | None = None) -> str:
    """Capture a ``torch.profiler`` trace of the NEXT ``seconds`` of
    whatever the process is doing — the on-demand form behind
    ``POST /api/debug/profile?seconds=N``: live traffic keeps flowing
    while the capture runs, so the trace shows the real serving mix.
    Blocking: run from a worker thread. Returns the trace directory.

    Raises ``ValueError`` for a silly duration, ``ProfilingDisabled`` (a
    ``RuntimeError``) when no trace directory is configured (``--profile-dir`` /
    ``$OPSAGENT_PROFILE_DIR`` — operator-configured only, so a network
    client cannot mint an arbitrary-filesystem-write primitive), and
    ``RuntimeError`` from ``start_trace`` when a capture is already running
    (the server tells the two apart: the first is 403, the second 409)."""
    if not 0 < seconds <= MAX_CAPTURE_SECONDS:
        raise ValueError(
            f"seconds must be in (0, {MAX_CAPTURE_SECONDS:.0f}], "
            f"got {seconds}"
        )
    logdir = logdir or profile_dir()
    if not logdir:
        raise ProfilingDisabled(
            "profiling not enabled: start the server with --profile-dir "
            "(or set OPSAGENT_PROFILE_DIR)"
        )
    start_trace(logdir)
    log.info(f"on-demand profile capture started ({seconds}s) -> {logdir}")
    try:
        time.sleep(seconds)
    finally:
        path = stop_trace()
        log.info(f"on-demand profile capture written -> {path}")
    return logdir


def save_device_memory_profile(path: str) -> None:
    """Write the CUDA caching allocator's snapshot
    (``torch.cuda.memory._snapshot()``, pickled: the format PyTorch's
    memory viewer reads) — which blocks hold device memory right now.
    Raises on a process without a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: there is no device memory to profile")
    snap = torch.cuda.memory._snapshot()
    with open(path, "wb") as f:
        pickle.dump(snap, f)
