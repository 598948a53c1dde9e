"""Conveyor tool overlap: launch tools mid-decode from the constrained
stream (the port's copy of ``opsagent_tpu/agent/conveyor.py``).

A turn against the port's engine decodes under the ToolPrompt FSM
(serving/constrained.py), which pins the JSON's *shape*: properties
arrive in schema declaration order (``action.name`` before
``action.input``, both before ``observation``/``final_answer``), strings
cannot contain a raw ``"`` or newline (only escapes), and whitespace is
bounded. So the instant the bytes closing ``action.input`` stream out,
the tool call is fully determined while the JSON *tail* is still
decoding; that tail is the overlap window this module exploits.

Three pieces:

- ``StreamParser``: an incremental JSON event parser fed by decode
  deltas. Single-pass with no backtracking *because* of the DFA
  guarantees above. Emits ``tool_name_closed`` / ``arg_closed(field)`` /
  ``call_closed`` events.

- ``ToolLaunch``: one early tool execution on a worker thread that runs
  the registry callable inside a ``proc.cancel_scope`` so ``cancel()``
  can group-kill any subprocess the callable spawned. The ``tool.exec``
  / ``tool.timeout`` fault points fire inside the worker, exactly where
  the blocking path fires them.

- ``TurnConveyor``: the per-LLM-turn driver the ReAct loop feeds:
  watches parser events, and at launch readiness (known tool name + the
  wire fields its LAUNCH_FIELDS ride in, see tools.wire_fields_for)
  parks the session's KV (pages free while the tail still decodes),
  records the ``tool_exec`` enter flight event stamped
  ``launch_offset_ms``, and starts the ``ToolLaunch``.

Correctness contract: the launch is a *prefix bet*. On ``call_closed``
the loop validates the fully-parsed call against the launched prefix;
mismatch (or a launch error) cancels the early process and falls back to
the blocking path, so transcripts are byte-identical conveyor-on vs
conveyor-off. ``stream_constrained_turn`` sends the blocking path's
request body, so the streamed text is the blocking call's text.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

from .. import obs
from ..llm.client import LLMError
from ..serving import faults
from ..tools import Tool, ToolError, wire_fields_for
from ..utils.logger import get_logger
from ..utils.perf import get_perf_stats

log = get_logger("agent.conveyor")


def enabled() -> bool:
    """Conveyor launches are on unless OPSAGENT_CONVEYOR=0 (the bench
    A/B reads this per turn, so a phase flip needs no re-import)."""
    import os

    return os.environ.get("OPSAGENT_CONVEYOR", "1") != "0"


# -- incremental JSON event parser -----------------------------------------


@dataclass
class Event:
    kind: str  # tool_name_closed | arg_closed | call_closed | field_closed
    path: tuple[str, ...] = ()
    field: str = ""
    value: Any = None


@dataclass
class _Frame:
    kind: str  # "obj" | "arr"
    key: str | None = None
    expect: str = "key"  # obj: key|colon|value|comma ; arr: value|comma
    scalar: list[str] = field(default_factory=list)


def _call_path(schema: dict | None) -> tuple[str, ...]:
    """Locate the nested tool-call object in the schema: the property
    whose value is an object with a ``name`` property (``action`` in
    TOOLPROMPT_SCHEMA). The same declaration order the DFA compiles
    (schema_to_regex emits properties in order) guarantees its fields
    close in that order on the stream."""
    for key, sub in ((schema or {}).get("properties") or {}).items():
        if isinstance(sub, dict) and "name" in (sub.get("properties") or {}):
            return (key,)
    return ("action",)


class StreamParser:
    """Incremental, split-anywhere JSON parser over the constrained
    decode stream. ``feed`` accepts deltas of any granularity (a token's
    detokenization can split escapes and multi-byte text arbitrarily)
    and returns the events the new bytes completed."""

    def __init__(self, schema: dict | None = None) -> None:
        self._stack: list[_Frame] = []
        self._str: list[str] | None = None
        self._str_role = "value"
        self._esc = False
        self._closed = False
        self._call_path = _call_path(schema)

    def feed(self, text: str) -> list[Event]:
        events: list[Event] = []
        for ch in text:
            self._step(ch, events)
        return events

    # -- internals ---------------------------------------------------------

    def _path(self) -> tuple[str, ...]:
        return tuple(f.key or "" for f in self._stack)

    def _step(self, ch: str, events: list[Event]) -> None:
        if self._closed:
            return
        if self._str is not None:
            if self._esc:
                self._str.append(ch)
                self._esc = False
                return
            if ch == "\\":
                self._str.append(ch)
                self._esc = True
                return
            if ch == '"':
                raw = "".join(self._str)
                self._str = None
                try:
                    value = json.loads(f'"{raw}"')
                except json.JSONDecodeError:
                    value = raw
                self._close_string(value, events)
                return
            self._str.append(ch)
            return

        frame = self._stack[-1] if self._stack else None
        if frame is not None and frame.scalar:
            # Non-string scalar (number/true/false/null) in flight: any
            # structural delimiter closes it.
            if ch not in ",}]" and not ch.isspace():
                frame.scalar.append(ch)
                return
            raw = "".join(frame.scalar)
            frame.scalar.clear()
            try:
                value = json.loads(raw)
            except json.JSONDecodeError:
                value = raw
            self._emit_value(value, events)
            frame.expect = "comma"
            # fall through: ch still needs structural handling

        if ch.isspace():
            return
        if ch == '"':
            self._str = []
            self._esc = False
            self._str_role = (
                "key"
                if frame is not None
                and frame.kind == "obj"
                and frame.expect == "key"
                else "value"
            )
            return
        if ch == "{":
            self._stack.append(_Frame("obj", expect="key"))
            return
        if ch == "[":
            self._stack.append(_Frame("arr", expect="value"))
            return
        if ch in "}]":
            if not self._stack:
                return
            closed = self._stack.pop()
            if not self._stack:
                self._closed = True
                events.append(Event("call_closed"))
                return
            parent = self._stack[-1]
            if closed.kind == "obj" and self._path() == self._call_path:
                # The tool-call object itself closed (all args final).
                events.append(Event("field_closed", self._path()))
            parent.expect = "comma"
            return
        if ch == ":":
            if frame is not None:
                frame.expect = "value"
            return
        if ch == ",":
            if frame is not None:
                frame.expect = "key" if frame.kind == "obj" else "value"
            return
        if frame is not None and frame.expect == "value":
            frame.scalar.append(ch)

    def _close_string(self, value: str, events: list[Event]) -> None:
        frame = self._stack[-1] if self._stack else None
        if frame is None:
            return
        if frame.kind == "obj" and self._str_role == "key":
            frame.key = value
            frame.expect = "colon"
            return
        self._emit_value(value, events)
        frame.expect = "comma"

    def _emit_value(self, value: Any, events: list[Event]) -> None:
        path = self._path()
        call = self._call_path
        if path == call + ("name",):
            events.append(Event("tool_name_closed", path, "name", value))
        elif len(path) == len(call) + 1 and path[: len(call)] == call:
            events.append(Event("arg_closed", path, path[-1], value))
        else:
            events.append(Event("field_closed", path, path[-1], value))


# -- async tool launch -----------------------------------------------------


class ToolLaunch:
    """One conveyor tool execution on a worker thread.

    The worker wraps the registry callable in a ``proc.cancel_scope`` so
    subprocesses it spawns (via tools/proc.py) are killable from the
    loop thread on a mismatch-cancel. The ``tool.exec``/``tool.timeout``
    fault points fire inside the worker — the same injection surface the
    classic blocking path has, now covering the async executor.
    """

    def __init__(self, name: str, tool_input: str, fn: Tool) -> None:
        from ..tools import proc

        self.name = name
        self.input = tool_input
        self.t_launch = time.perf_counter()
        self.t_done: float | None = None
        self.cancelled = False
        self._procs: list[Any] = []
        self._proc_mod = proc
        self._result: str | None = None
        self._error: BaseException | None = None
        self._done = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(fn,), daemon=True,
            name=f"conveyor-{name}",
        )
        self._thread.start()

    def _run(self, fn: Tool) -> None:
        try:
            with self._proc_mod.cancel_scope(self._procs):
                faults.maybe_raise(
                    "tool.exec", ToolError,
                    "injected tool subprocess failure", tool=self.name,
                )
                faults.maybe_raise(
                    "tool.timeout", TimeoutError,
                    "injected tool subprocess timeout", tool=self.name,
                )
                self._result = fn(self.input)
        except BaseException as e:  # noqa: BLE001 - delivered via result()
            self._error = e
        finally:
            self.t_done = time.perf_counter()
            self._done.set()

    def matches(self, name: str, tool_input: str) -> bool:
        return self.name == name and self.input == tool_input

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: float | None = None) -> bool:
        return self._done.wait(timeout)

    def error(self) -> BaseException | None:
        return self._error if self._done.is_set() else None

    def result(self) -> str:
        """Block for the worker; re-raise its failure, else the
        observation."""
        self._done.wait()
        if self._error is not None:
            raise self._error
        return self._result or ""

    def cancel(self) -> None:
        """Mismatch/abandon: group-kill every subprocess the callable
        spawned; the worker unwinds on its own."""
        self.cancelled = True
        for p in list(self._procs):
            try:
                p.cancel()
            except Exception:  # noqa: BLE001 - best-effort reaping
                pass


# -- per-turn driver -------------------------------------------------------


class TurnConveyor:
    """Watches one LLM turn's decode stream and launches the tool at
    readiness-close. Owned by the ReAct loop; ``on_delta`` runs on the
    stream-consuming thread between chunk pulls."""

    def __init__(
        self,
        tools: dict[str, Tool],
        model: str = "",
        park_messages: list[dict[str, Any]] | None = None,
        schema: dict | None = None,
    ) -> None:
        self.parser = StreamParser(schema)
        self.tools = tools
        self.model = model
        self.park_messages = park_messages
        self.launch: ToolLaunch | None = None
        self.parked_tokens = 0
        self.request_id = None
        self.t0 = time.perf_counter()
        self.t_stream_end: float | None = None
        self._name: str | None = None
        self._fields: dict[str, str] = {}
        cur = obs.current_span()
        if cur is not None:
            self.request_id = cur.trace.request_id

    def on_delta(self, text: str) -> None:
        for ev in self.parser.feed(text):
            if ev.kind == "tool_name_closed":
                self._name = str(ev.value)
            elif ev.kind == "arg_closed" and isinstance(ev.value, str):
                self._fields[ev.field] = ev.value
            self._maybe_launch()

    def finish_stream(self) -> None:
        self.t_stream_end = time.perf_counter()
        if self.launch is not None:
            obs.TOOL_LAUNCH_LEAD_SECONDS.observe(
                max(0.0, self.t_stream_end - self.launch.t_launch),
                tool=self.launch.name,
            )

    def overlap_s(self) -> float:
        """Seconds the tool ran concurrently with decode: launch →
        min(tool end, stream end). Callable once both ends are known."""
        if self.launch is None:
            return 0.0
        t_end = self.t_stream_end or time.perf_counter()
        t_done = self.launch.t_done or time.perf_counter()
        return max(0.0, min(t_done, t_end) - self.launch.t_launch)

    def abort(self, outcome: str = "cancelled") -> None:
        """Cancel an in-flight launch and close its flight pair."""
        if self.launch is None:
            return
        self.launch.cancel()
        self.record_exit(outcome)

    def record_exit(
        self, outcome: str, error: str = "", overlap_s: float | None = None
    ) -> None:
        """Close the launch's flight pair (the enter was recorded at
        launch time, stamped launch_offset_ms)."""
        assert self.launch is not None
        dt = (self.launch.t_done or time.perf_counter()) - self.launch.t_launch
        ev: dict[str, Any] = {
            "tool": self.launch.name, "phase": "exit", "outcome": outcome,
            "duration_ms": round(dt * 1e3, 3), "conveyor": True,
            "request_id": self.request_id,
        }
        if overlap_s is not None:
            ev["overlap_ms"] = round(overlap_s * 1e3, 3)
        if self.parked_tokens:
            ev["parked_tokens"] = self.parked_tokens
        if error:
            ev["error"] = error
        obs.flight.record("tool_exec", **ev)

    def _maybe_launch(self) -> None:
        if self.launch is not None or not self._name:
            return
        name = self._name
        if name not in self.tools:
            return
        if not wire_fields_for(name) <= set(self._fields):
            return
        tool_input = self._fields.get("input", "")
        # Tool-time parking moves from tool ENTRY to tool LAUNCH: the
        # divergent prior-generation subtree frees while the JSON tail is
        # still decoding (the live turn's own chain stays — its pages are
        # refcounted by the running sequence).
        if (self.model or "").startswith("cuda://") and self.park_messages:
            try:
                from ..serving.api import park_session

                self.parked_tokens = park_session(
                    self.model, self.park_messages
                )
            except Exception:  # noqa: BLE001 - parking is best-effort
                self.parked_tokens = 0
        launch_offset_ms = round((time.perf_counter() - self.t0) * 1e3, 3)
        enter_ev: dict[str, Any] = {
            "tool": name, "phase": "enter", "request_id": self.request_id,
            "launch_offset_ms": launch_offset_ms, "conveyor": True,
        }
        if self.parked_tokens:
            enter_ev["parked_tokens"] = self.parked_tokens
        obs.flight.record("tool_exec", **enter_ev)
        obs.TOOL_EARLY_LAUNCHES.inc(tool=name)
        self.launch = ToolLaunch(name, tool_input, self.tools[name])


# -- in-process constrained streaming --------------------------------------


def stream_constrained_turn(
    model: str,
    max_tokens: int,
    messages: list[dict[str, Any]],
    response_format: dict[str, Any] | None,
    on_delta: Callable[[str], None],
) -> str:
    """Drive the in-process cuda:// engine's stream, feeding content
    deltas to ``on_delta`` as they arrive; returns the full reply text.

    Builds the SAME request body ChatClient.chat_completion sends on the
    non-stream path (greedy temperature, identical fields), so the
    streamed text is byte-identical to what the blocking call returns —
    the conveyor-off transcript equality rests on this.
    """
    from ..serving.api import get_stack

    target = model.split("://", 1)[-1]
    body: dict[str, Any] = {
        "model": target,
        "messages": messages,
        "max_tokens": max_tokens,
        "temperature": 1e-45,
    }
    if response_format:
        body["response_format"] = response_format
    parts: list[str] = []
    try:
        stack = get_stack(target)
        with get_perf_stats().timer("llm.chat.cuda"):
            for chunk in stack.chat_completion_stream(body):
                err = chunk.get("error")
                if err:
                    raise LLMError(
                        f"cuda engine error: {err.get('message', err)}"
                    )
                choices = chunk.get("choices") or []
                if not choices:
                    continue
                delta = choices[0].get("delta") or {}
                piece = delta.get("content")
                if piece:
                    parts.append(piece)
                    on_delta(piece)
    except LLMError:
        raise
    except Exception as e:  # noqa: BLE001 - as the cuda:// provider does
        raise LLMError(f"cuda engine error: {e}") from e
    return "".join(parts)
