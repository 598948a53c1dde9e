"""The agent server's handlers (the port's counterpart of
``opsagent_tpu/server/handlers.py``, over the standard library's HTTP server
instead of aiohttp).

A handler takes a ``Request`` and returns a ``Response``, with the JAX
package's status codes and JSON bodies: ``login`` (the configured
credentials give a 24-hour HS256 token), ``version``, ``execute`` (the ReAct
loop under the request's trace, then the tolerant parse of its final reply
and the tool history rebuilt from the transcript), ``diagnose``, ``analyze``
(the live object through the analysis workflow), ``perf_stats`` /
``perf_reset`` and ``metrics``. The observability routes are the engine
server's (``serving/api.py`` ``ObsRoutes``).

Each request runs on its own thread (``server/app.py``), which opens the
request's trace: the loop's ``llm_turn`` and ``tool_exec`` spans, and under
``llm_turn`` the engine's, land under the request's root.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Mapping

from .. import VERSION, obs
from ..agent.prompts import DIAGNOSE_SYSTEM_PROMPT, EXECUTE_SYSTEM_PROMPT_CN
from ..agent.react import assistant_with_config
from ..llm.client import ChatClient, LLMError
from ..tools import ToolPrompt
from ..utils.globalstore import get_global
from ..utils.jsonrepair import extract_field, parse_json
from ..utils.logger import get_logger
from ..utils.perf import get_perf_stats, trace_func
from .jwtauth import issue_token

log = get_logger("server")

DEFAULT_USERNAME = "admin"
DEFAULT_PASSWORD = "novastar"
DEFAULT_MODEL = "gpt-4"
SERVER_MAX_TOKENS = 8192
SERVER_MAX_ITERATIONS = 5


@dataclass
class Request:
    """One HTTP request as a handler sees it."""

    method: str
    path: str
    query: dict[str, str]
    headers: Mapping[str, str]
    body: bytes = b""
    request_id: str = ""

    def json(self) -> Any:
        return json.loads(self.body.decode("utf-8"))


@dataclass
class Response:
    status: int
    body: bytes = b""
    content_type: str | None = None
    headers: dict[str, str] = field(default_factory=dict)


def json_response(data: Any, status: int = 200) -> Response:
    return Response(status, json.dumps(data).encode("utf-8"), "application/json; charset=utf-8")


def _json_body(request: Request) -> tuple[Any, Response | None]:
    try:
        return request.json(), None
    except json.JSONDecodeError:
        return None, json_response({"error": "invalid JSON body"}, status=400)


# -- auth -------------------------------------------------------------------
def login(request: Request) -> Response:
    body, err = _json_body(request)
    if err is not None:
        return err
    username = body.get("username", "")
    password = body.get("password", "")
    expected_user = get_global("username", DEFAULT_USERNAME)
    expected_pass = get_global("password", DEFAULT_PASSWORD)
    if username != expected_user or password != expected_pass:
        return json_response({"error": "invalid credentials"}, status=401)
    key = get_global("jwtKey", "")
    if not key:
        return json_response({"error": "server JWT key not configured"}, status=500)
    token = issue_token(username, key)
    return json_response({"token": token, "expires_in": 24 * 3600})


def version(request: Request) -> Response:
    return json_response({"version": VERSION})


# -- execute ----------------------------------------------------------------
def _tools_history(chat_history: list[dict[str, Any]]) -> list[dict[str, str]]:
    """Rebuild the tool-call history by re-parsing the user messages the
    ReAct loop marshaled."""
    out: list[dict[str, str]] = []
    for msg in chat_history:
        if msg.get("role") != "user":
            continue
        try:
            tp = ToolPrompt.from_json(msg.get("content") or "")
        except (ValueError, TypeError):
            continue
        if tp.action.name:
            out.append(
                {
                    "name": tp.action.name,
                    "input": tp.action.input,
                    "observation": tp.observation,
                }
            )
    return out


def _parse_agent_response(
    response: str,
    tools_history: list[dict[str, str]],
    show_thought: bool,
) -> dict[str, Any]:
    """Tolerant parse of the agent's final response: strict JSON -> regex
    field extraction -> repaired JSON -> generic map -> raw passthrough."""

    def ok(
        message: str,
        thought: str = "",
        question: str = "",
        action: Any = None,
        observation: str = "",
        raw: bool = False,
    ) -> dict[str, Any]:
        data: dict[str, Any] = {"message": message, "status": "success"}
        if raw:
            data["raw_response"] = True
        if show_thought:
            data["thought"] = thought
            data["question"] = question
            data["action"] = action if action is not None else {}
            data["observation"] = observation
            data["tools_history"] = tools_history
        return data

    # Stage 1: strict JSON with a final_answer.
    try:
        obj = json.loads(response)
        if isinstance(obj, dict) and obj.get("final_answer"):
            tp = ToolPrompt.from_dict(obj)
            return ok(
                tp.final_answer, tp.thought, tp.question,
                {"name": tp.action.name, "input": tp.action.input}, tp.observation,
            )
    except (json.JSONDecodeError, ValueError):
        pass

    # Stage 2: regex field extraction from JSON-ish text.
    final = extract_field(response, "final_answer")
    if final:
        return ok(
            final,
            extract_field(response, "thought"),
            extract_field(response, "question"),
            extract_field(response, "action"),
            extract_field(response, "observation"),
        )

    # Stage 3: repair then parse (parse_json retries with clean_json itself).
    try:
        obj = parse_json(response)
        if isinstance(obj, dict):
            if obj.get("final_answer"):
                tp = ToolPrompt.from_dict(obj)
                return ok(
                    tp.final_answer, tp.thought, tp.question,
                    {"name": tp.action.name, "input": tp.action.input}, tp.observation,
                )
            # Stage 4: generic map — surface whatever fields exist.
            msg = obj.get("message") or obj.get("answer") or obj.get("content")
            if isinstance(msg, str) and msg:
                return ok(msg, str(obj.get("thought") or ""))
    except ValueError:
        pass

    # Stage 5: raw passthrough.
    return ok(response, raw=True)


def execute(request: Request) -> Response:
    perf = get_perf_stats()
    stop = trace_func("execute_total")
    try:
        api_key = request.headers.get("X-API-Key", "")
        if not api_key and not get_global("allowAnonymousLLM", False):
            return json_response({"error": "Missing API Key"}, status=400)
        body, err = _json_body(request)
        if err is not None:
            return err
        instructions = body.get("instructions", "")
        if not instructions:
            return json_response({"error": "instructions is required"}, status=400)

        show_thought_q = request.query.get("show-thought", "")
        if show_thought_q != "":
            show_thought = show_thought_q == "true"
        else:
            show_thought = bool(get_global("showThought", False))

        model = body.get("currentModel") or DEFAULT_MODEL
        base_url = body.get("baseUrl") or ""
        messages = [
            {"role": "system", "content": EXECUTE_SYSTEM_PROMPT_CN},
            {"role": "user", "content": instructions},
        ]
        # The request's span tree is rooted on the ingress request ID and
        # the loop runs on this thread inside it: its llm_turn and
        # tool_exec spans land under this root.
        rid = request.request_id or obs.new_request_id()
        try:
            with obs.trace_request(rid):
                response, history = assistant_with_config(
                    model,
                    messages,
                    SERVER_MAX_TOKENS,
                    True,
                    True,
                    SERVER_MAX_ITERATIONS,
                    api_key,
                    base_url,
                )
        except LLMError as e:
            return json_response(
                {"error": f"agent failed: {e}", "status": "error", "request_id": rid},
                status=500,
            )
        tools_history = _tools_history(history)
        with perf.timer("execute_response_parse"):
            data = _parse_agent_response(response, tools_history, show_thought)
        data["request_id"] = rid
        return json_response(data)
    finally:
        stop()


# -- analyze / diagnose -----------------------------------------------------
def analyze(request: Request) -> Response:
    """Fetch the live object and run the analysis workflow."""
    body, err = _json_body(request)
    if err is not None:
        return err
    resource = body.get("resource", "pod")
    name = body.get("name", "")
    namespace = body.get("namespace", "default")
    if not name:
        return json_response({"error": "name is required"}, status=400)
    model = body.get("currentModel") or DEFAULT_MODEL
    api_key = request.headers.get("X-API-Key", "")
    base_url = body.get("baseUrl") or ""
    try:
        from ..k8s import get_yaml
        from ..workflows import analysis_flow

        manifest = get_yaml(resource, name, namespace)
        client = ChatClient(api_key=api_key, base_url=base_url)
        result = analysis_flow(model, manifest, client=client)
    except Exception as e:  # noqa: BLE001 - surfaced as HTTP error
        return json_response({"error": str(e), "status": "error"}, status=500)
    return json_response({"message": result, "status": "success"})


def diagnose(request: Request) -> Response:
    """Diagnose a pod with the ReAct loop."""
    body, err = _json_body(request)
    if err is not None:
        return err
    pod = body.get("pod") or body.get("name") or ""
    namespace = body.get("namespace", "default")
    if not pod:
        return json_response({"error": "pod is required"}, status=400)
    model = body.get("currentModel") or DEFAULT_MODEL
    api_key = request.headers.get("X-API-Key", "")
    base_url = body.get("baseUrl") or ""
    messages = [
        {"role": "system", "content": DIAGNOSE_SYSTEM_PROMPT},
        {
            "role": "user",
            "content": f"Diagnose the Pod '{pod}' in namespace '{namespace}'.",
        },
    ]
    try:
        response, history = assistant_with_config(
            model, messages, SERVER_MAX_TOKENS, True, True,
            SERVER_MAX_ITERATIONS, api_key, base_url,
        )
    except LLMError as e:
        return json_response({"error": f"diagnose failed: {e}", "status": "error"}, status=500)
    return json_response(_parse_agent_response(response, _tools_history(history), False))


# -- perf / metrics -----------------------------------------------------------
def perf_stats(request: Request) -> Response:
    return json_response({"stats": get_perf_stats().get_stats()})


def perf_reset(request: Request) -> Response:
    get_perf_stats().reset()
    return json_response({"status": "reset"})


def metrics(request: Request) -> Response:
    """Prometheus text exposition of the process-wide registry (a co-hosted
    engine's instruments included)."""
    return Response(200, obs.metrics_text().encode("utf-8"), "text/plain; charset=utf-8")
