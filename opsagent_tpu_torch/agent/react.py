"""The ReAct agent core: the central tool-dispatch loop (the port's copy of
``opsagent_tpu/agent/react.py``).

``assistant`` / ``assistant_with_config`` run a JSON-formatted ReAct loop
against a chat model, with its robustness ladder:

- an unparseable FIRST reply is treated as the final answer;
- an iteration cap;
- a ``final_answer`` is accepted only when it is not template/placeholder
  text AND at least one observation has been made;
- tool failures become observations ("Tool X failed with error ..."),
  unknown tools likewise;
- observations are truncated to 1024 tokens;
- the updated ToolPrompt is marshaled back as a **user** message (the
  serving engine's prefix cache keys on it);
- an unparseable mid-loop reply triggers one summarization turn and a
  best-effort ``final_answer`` extraction.

Against the port's engine (``cuda://<name>``, as model or base URL) a turn
decodes under the ToolPrompt JSON schema on the device, streams through the
conveyor (``agent/conveyor.py``) unless ``OPSAGENT_CONVEYOR=0``, and the
session's KV is parked to the host tier while a tool runs.

The loop returns the model's final raw reply; consumers (the execute
handler's tolerant parse ladder, the CLI) extract ``final_answer``
themselves.
"""

from __future__ import annotations

import re
import time
from typing import Any

from .. import obs
from ..llm.client import ChatClient
from ..serving import faults
from ..llm.tokens import constrict_messages, constrict_prompt, get_token_limits
from ..tools import ToolPrompt, get_tools, ToolError
from ..utils.jsonrepair import extract_field
from ..utils.logger import get_logger
from ..utils.perf import get_perf_stats, trace_func
from . import conveyor
from .prompts import SUMMARIZE_PROMPT

log = get_logger("agent")

OBSERVATION_TOKEN_LIMIT = 1024

_PLACEHOLDER = re.compile(r"<[^<>\n]{0,80}>")


def is_template_value(value: str) -> bool:
    """Reject placeholder/template final answers: empty, contains
    ``<final_answer``-style markers or any ``<...>`` placeholder, or is
    implausibly short."""
    v = value.strip()
    if not v:
        return True
    if "<final_answer" in v or "final_answer>" in v:
        return True
    if _PLACEHOLDER.search(v):
        return True
    if len(v) < 10:
        return True
    return False


def assistant(
    model: str,
    messages: list[dict[str, Any]],
    max_tokens: int = 2048,
    count_tokens: bool = False,
    verbose: bool = False,
    max_iterations: int = 10,
) -> tuple[str, list[dict[str, Any]]]:
    """Run the ReAct loop with credentials from the environment."""
    return assistant_with_config(
        model, messages, max_tokens, count_tokens, verbose, max_iterations, "", ""
    )


def assistant_with_config(
    model: str,
    messages: list[dict[str, Any]],
    max_tokens: int = 2048,
    count_tokens: bool = False,
    verbose: bool = False,
    max_iterations: int = 10,
    api_key: str = "",
    base_url: str = "",
) -> tuple[str, list[dict[str, Any]]]:
    """Run the ReAct loop; returns (final raw reply, full chat history).

    ``messages`` must hold the system prompt and the user instruction; the
    list is extended in place with every turn so callers can reconstruct the
    tool history afterwards (as the execute handler does).
    """
    stop = trace_func("agent.loop")
    # Span-tree root: reuse the caller's active trace (the execute handler
    # roots one on the HTTP request ID); a direct CLI/library call gets its
    # own request-scoped trace so llm_turn / tool_exec spans always land
    # somewhere retrievable.
    if obs.current_span() is not None:
        import contextlib

        tracer = contextlib.nullcontext()
    else:
        tracer = obs.trace_request(obs.new_request_id("agent"))
    try:
        with tracer:
            return _react_loop(
                model, messages, max_tokens, count_tokens, verbose,
                max_iterations, api_key, base_url,
            )
    finally:
        stop()


def _react_loop(
    model: str,
    chat_history: list[dict[str, Any]],
    max_tokens: int,
    count_tokens: bool,
    verbose: bool,
    max_iterations: int,
    api_key: str,
    base_url: str,
) -> tuple[str, list[dict[str, Any]]]:
    ps = get_perf_stats()
    client = ChatClient(api_key=api_key, base_url=base_url)
    tools = get_tools()
    # A completion budget >= the model's context window would leave zero room
    # for the prompt (and the constrictor would evict history to nothing).
    max_tokens = min(max_tokens, max(256, get_token_limits(model) // 2))

    # Against the in-tree engine, constrain decoding to the ToolPrompt JSON
    # schema on device: replies are valid by construction, so the repair
    # ladder below is dead code on this path. Remote providers keep
    # free-form output + repair.
    toolprompt_rf = None
    if (model or "").startswith("cuda://") or (base_url or "").startswith("cuda://"):
        from ..serving.constrained import TOOLPROMPT_SCHEMA

        toolprompt_rf = {
            "type": "json_schema",
            "json_schema": {"schema": TOOLPROMPT_SCHEMA},
        }

    def call(
        msgs: list[dict[str, Any]],
        response_format: dict[str, Any] | None = None,
    ) -> str:
        sendable = constrict_messages(msgs, model, max_tokens) if count_tokens else msgs
        obs.AGENT_ITERATIONS.inc()
        # The llm_turn span is the bridge into the engine: against the
        # in-process cuda:// provider the frontend sees this as the current
        # span and nests its generate/queue/prefill/decode children here.
        with ps.timer("agent.llm_turn"), obs.span("llm_turn"):
            return client.chat(
                model, max_tokens, sendable, response_format=response_format
            )

    # Conveyor tool overlap (agent/conveyor.py): when the turn decodes
    # under the ToolPrompt constraint in-process, stream it and launch the
    # tool the moment its argument fields close — the JSON tail decodes
    # while the subprocess already runs. The launch is validated against
    # the full parse below; any divergence cancels it and re-runs the
    # classic blocking path, so transcripts are byte-identical on vs off.
    use_conveyor = toolprompt_rf is not None and conveyor.enabled()

    def call_turn(
        msgs: list[dict[str, Any]],
    ) -> tuple[str, "conveyor.TurnConveyor | None"]:
        if not use_conveyor:
            return call(msgs, response_format=toolprompt_rf), None
        sendable = constrict_messages(msgs, model, max_tokens) if count_tokens else msgs
        obs.AGENT_ITERATIONS.inc()
        with ps.timer("agent.llm_turn"), obs.span("llm_turn"):
            turn = conveyor.TurnConveyor(
                tools, model=model, park_messages=sendable,
                schema=toolprompt_rf["json_schema"]["schema"],
            )
            try:
                streamed = conveyor.stream_constrained_turn(
                    model, max_tokens, sendable, toolprompt_rf,
                    turn.on_delta,
                )
            except BaseException:
                # The engine call failed; a speculative launch must not
                # outlive the turn it bet on.
                turn.abort()
                raise
            turn.finish_stream()
        return streamed, turn

    def consume_launch(
        turn: "conveyor.TurnConveyor", name: str
    ) -> str | None:
        """Collect an early launch's observation; None = launch errored
        (the caller falls back to the classic blocking relaunch)."""
        launch = turn.launch
        assert launch is not None
        t_wait = time.perf_counter()
        try:
            # The tool_exec span covers only the RESIDUAL wait — the
            # overlapped part of the tool's runtime was decode time, not
            # blocked time, and the goodput ledger sees it the same way.
            with ps.timer(f"agent.tool.{name}"), \
                    obs.span("tool_exec", tool=name):
                observation = launch.result()
        except Exception as e:  # noqa: BLE001 - incl. injected faults
            obs.TOOL_CALLS.inc(tool=name, outcome="error")
            turn.record_exit("error", str(e))
            if verbose:
                log.info("conveyor launch failed (%s); falling back", e)
            return None
        residual = time.perf_counter() - t_wait
        obs.attribution.record_goodput(residual, "tool_blocked")
        overlap = turn.overlap_s()
        obs.TOOL_OVERLAP_SECONDS.inc(overlap)
        obs.TOOL_CALLS.inc(tool=name, outcome="ok")
        turn.record_exit("ok", overlap_s=overlap)
        return observation

    reply, turn = call_turn(chat_history)
    chat_history.append({"role": "assistant", "content": reply})
    if verbose:
        log.info("initial reply: %s", reply[:500])

    try:
        prompt = ToolPrompt.from_json(reply)
    except ValueError:
        # Unparseable first reply: treat the raw text as the final answer.
        if turn is not None:
            turn.abort()
        return reply, chat_history

    iterations = 0
    while True:
        iterations += 1
        if iterations > max_iterations:
            log.warning("iteration cap %d reached", max_iterations)
            if turn is not None:
                turn.abort()
            return reply, chat_history

        if prompt.final_answer and not is_template_value(prompt.final_answer):
            if prompt.observation.strip():
                if turn is not None:
                    turn.abort()
                return reply, chat_history
            if verbose:
                log.info("final_answer offered without observation; continuing")

        name = prompt.action.name.strip()
        tool_input = prompt.action.input
        launch = turn.launch if turn is not None else None
        observation: str | None = None
        if name and name in tools and launch is not None:
            if launch.matches(name, tool_input):
                # The launched prefix IS the parsed call: collect the
                # overlapped execution (None = launch errored; the
                # classic block below relaunches inline).
                observation = consume_launch(turn, name)
            else:
                # Launched prefix ≠ final parse (the stream-side extract
                # and the repair-ladder parse disagreed): cancel the bet,
                # run the classic path. The flight ring records both
                # pairs — the cancelled early launch and the relaunch.
                turn.abort()
                launch = None
        elif launch is not None:
            # The parsed reply doesn't dispatch a registered tool at all
            # (final answer / unknown tool): abandon the speculation.
            turn.abort()
            launch = None
        if observation is not None:
            pass  # conveyor launch delivered the observation
        elif name and name in tools:
            if verbose:
                log.info("tool %s input=%r", name, tool_input[:200])
            # Tool-time parking (hierarchical KV tier): the subprocess the
            # tool is about to exec blocks this session for seconds; an
            # in-tree engine can copy the session's KV pages to host RAM
            # and free the HBM for queued prompts — the next turn restores
            # them instead of re-prefilling. No-op for remote providers
            # and engines without the offload tier. A conveyor turn
            # already parked at LAUNCH time — don't double-count.
            parked_tokens = 0
            if (model or "").startswith("cuda://") and not (
                turn is not None and turn.launch is not None
            ):
                try:
                    from ..serving.api import park_session

                    parked_tokens = park_session(model, chat_history)
                except Exception:  # noqa: BLE001 - parking is best-effort
                    parked_tokens = 0
            t_tool = time.perf_counter()
            # Tool ENTRY and EXIT are separate flight events (phase=
            # enter/exit): the exit carries duration + outcome, so a
            # timeline can bound the tool-blocked window exactly and
            # park/unpark pairs (parked_tokens on the enter) are
            # auditable against the restore that follows.
            _cur = obs.current_span()
            _rid = _cur.trace.request_id if _cur is not None else None
            enter_ev = {"tool": name, "phase": "enter", "request_id": _rid}
            if parked_tokens:
                enter_ev["parked_tokens"] = parked_tokens
            obs.flight.record("tool_exec", **enter_ev)

            def _tool_flight(outcome: str, error: str = "") -> None:
                dt = time.perf_counter() - t_tool
                ev = {
                    "tool": name, "phase": "exit", "outcome": outcome,
                    "duration_ms": round(dt * 1e3, 3),
                    "request_id": _rid,
                }
                if parked_tokens:
                    ev["parked_tokens"] = parked_tokens
                if error:
                    ev["error"] = error
                obs.flight.record("tool_exec", **ev)
                obs.attribution.record_goodput(dt, "tool_blocked")

            try:
                with ps.timer(f"agent.tool.{name}"), \
                        obs.span("tool_exec", tool=name):
                    faults.maybe_raise(
                        "tool.exec", ToolError,
                        "injected tool subprocess failure", tool=name,
                    )
                    faults.maybe_raise(
                        "tool.timeout", TimeoutError,
                        "injected tool subprocess timeout", tool=name,
                    )
                    observation = tools[name](tool_input)
                obs.TOOL_CALLS.inc(tool=name, outcome="ok")
                _tool_flight("ok")
            except ToolError as e:
                obs.TOOL_CALLS.inc(tool=name, outcome="error")
                _tool_flight("error", str(e))
                observation = (
                    f"Tool {name} failed with error {e}. "
                    "Considering refine the inputs for the tool."
                )
            except Exception as e:  # noqa: BLE001 - tool bugs become observations
                obs.TOOL_CALLS.inc(tool=name, outcome="error")
                _tool_flight("error", str(e))
                observation = (
                    f"Tool {name} failed with error {e}. "
                    "Considering refine the inputs for the tool."
                )
        elif name:
            observation = (
                f"Tool {name} is not available. Considering switch to other tools."
            )
        else:
            observation = (
                "No action was specified. Specify a tool action or give the "
                "final_answer."
            )

        prompt.observation = constrict_prompt(observation, OBSERVATION_TOKEN_LIMIT)
        chat_history.append({"role": "user", "content": prompt.to_json()})

        reply, turn = call_turn(chat_history)
        chat_history.append({"role": "assistant", "content": reply})
        if verbose:
            log.info("iteration %d reply: %s", iterations, reply[:500])

        try:
            prompt = ToolPrompt.from_json(reply)
        except ValueError:
            # Mid-loop unparseable reply: one summarization turn, then a
            # best-effort final_answer extraction.
            if turn is not None:
                turn.abort()
            chat_history.append({"role": "user", "content": SUMMARIZE_PROMPT})
            reply = call(chat_history)
            chat_history.append({"role": "assistant", "content": reply})
            final = extract_field(reply, "final_answer") or reply
            return final, chat_history
