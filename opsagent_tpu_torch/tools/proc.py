"""Shared subprocess spawn/timeout plumbing for the tool layer (the port's
copy of ``opsagent_tpu/tools/proc.py``).

- ``run(...)``: the blocking helper every tool calls. The same
  CompletedProcess contract as ``subprocess.run(capture_output=True,
  text=True)``, but the child runs in its own **process group**
  (``start_new_session=True``) and a timeout kills the whole group:
  SIGTERM, a short grace window, then SIGKILL. ``FileNotFoundError``
  propagates from spawn exactly like ``subprocess.run`` (kubectl/trivy
  turn it into "not available", jq falls back to its built-in
  evaluator).

- ``ToolProcess``: the async form conveyor tool launches use
  (agent/conveyor.py): Popen + an output-capture thread + a timeout
  watchdog + ``cancel()``. The blocking ``run`` is implemented on top of
  it, so both paths share one kill discipline.

- ``cancel_scope(...)``: a thread-local registry: processes spawned on
  a thread inside the scope are killable from *another* thread. The
  conveyor launch worker wraps the tool callable in one so a
  mismatch-cancel can reap a subprocess it never got a handle to.
"""

from __future__ import annotations

import contextlib
import os
import signal
import subprocess
import threading
import time
from typing import Iterator

# Grace between the group SIGTERM and the follow-up SIGKILL. Short: tool
# children are bash pipelines / scanners, not databases with shutdown
# hooks, and the agent turn is latency-bound on this path.
KILL_GRACE_S = float(os.environ.get("OPSAGENT_TOOL_KILL_GRACE_S", "1.0"))

_scope_tls = threading.local()


@contextlib.contextmanager
def cancel_scope(procs: list["ToolProcess"]) -> Iterator[list["ToolProcess"]]:
    """Register every ToolProcess spawned on this thread into ``procs``."""
    prev = getattr(_scope_tls, "procs", None)
    _scope_tls.procs = procs
    try:
        yield procs
    finally:
        _scope_tls.procs = prev


def _kill_group(pid: int, grace_s: float = KILL_GRACE_S) -> None:
    """SIGTERM the child's process group, wait ``grace_s``, SIGKILL what
    survives. Tolerates the group being gone already at every step."""
    try:
        pgid = os.getpgid(pid)
    except (ProcessLookupError, PermissionError):
        return
    try:
        os.killpg(pgid, signal.SIGTERM)
    except (ProcessLookupError, PermissionError):
        return
    # Existence-poll with signal 0 (never waitpid here: reaping belongs
    # to the Popen owner's communicate/wait). A zombie keeps the group
    # alive until reaped, so the fallback SIGKILL may hit an already-dead
    # group — harmless.
    deadline = time.monotonic() + grace_s
    while time.monotonic() < deadline:
        try:
            os.killpg(pgid, 0)
        except (ProcessLookupError, PermissionError):
            return
        time.sleep(0.02)
    try:
        os.killpg(pgid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass


class ToolProcess:
    """One tool subprocess with captured output, a timeout watchdog, and
    group-kill cancel — the async executor conveyor launches run on.

    Spawn errors (``FileNotFoundError`` for a missing binary) raise
    synchronously from the constructor, preserving each tool's
    "not available" / built-in-fallback handling.
    """

    def __init__(
        self,
        argv: list[str],
        input_text: str | None = None,
        timeout: float | None = None,
        cwd: str | None = None,
    ) -> None:
        self.argv = argv
        self.timeout = timeout
        self.stdout = ""
        self.stderr = ""
        self.returncode: int | None = None
        self.timed_out = False
        self.cancelled = False
        self._done = threading.Event()
        self.proc = subprocess.Popen(
            argv,
            stdin=subprocess.PIPE if input_text is not None else None,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
            cwd=cwd,
            start_new_session=True,
        )
        scope = getattr(_scope_tls, "procs", None)
        if scope is not None:
            scope.append(self)
        # communicate() owns stdin write + both pipe drains; the thread
        # exists so wait() callers get a timeout watchdog that group-kills
        # instead of subprocess.run's pipe-leaking TimeoutExpired.
        self._reader = threading.Thread(
            target=self._communicate, args=(input_text,), daemon=True
        )
        self._reader.start()

    def _communicate(self, input_text: str | None) -> None:
        try:
            try:
                out, err = self.proc.communicate(input_text, self.timeout)
            except subprocess.TimeoutExpired:
                self.timed_out = True
                _kill_group(self.proc.pid)
                out, err = self.proc.communicate()
            except BaseException:
                _kill_group(self.proc.pid)
                raise
            self.stdout, self.stderr = out or "", err or ""
            self.returncode = self.proc.returncode
        finally:
            self._done.set()

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: float | None = None) -> bool:
        return self._done.wait(timeout)

    def cancel(self) -> None:
        """Group-kill the child; the capture thread reaps it."""
        self.cancelled = True
        _kill_group(self.proc.pid, grace_s=0.2)

    def result(self) -> subprocess.CompletedProcess:
        """Block for completion; CompletedProcess on exit, TimeoutExpired
        after the group was killed for overrunning its budget."""
        self._done.wait()
        if self.timed_out:
            raise subprocess.TimeoutExpired(self.argv, self.timeout or 0.0)
        return subprocess.CompletedProcess(
            self.argv, self.returncode or 0, self.stdout, self.stderr
        )


def run(
    argv: list[str],
    input_text: str | None = None,
    timeout: float | None = None,
    cwd: str | None = None,
) -> subprocess.CompletedProcess:
    """Blocking spawn with group-kill timeout — the shared helper every
    tool calls in place of ``subprocess.run(capture_output=True,
    text=True)``."""
    return ToolProcess(
        argv, input_text=input_text, timeout=timeout, cwd=cwd
    ).result()
