"""Native function-calling agent loop (the port's copy of
``opsagent_tpu/agent/funcall.py``).

Tools exposed as typed OpenAI ``tools``/``tool_calls`` functions rather than
the ReAct JSON: a loop that sends tool schemas, lets the model emit
``tool_calls``, executes them, and feeds ``role: tool`` results back until
the model answers in plain text. The workflows (``workflows/flows.py``) run
on it.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Callable

from ..llm.client import ChatClient
from ..tools import ToolError
from ..utils.logger import get_logger

log = get_logger("funcall")


@dataclass
class AgentFunction:
    """A typed tool exposed through the OpenAI tools schema."""

    name: str
    description: str
    parameters: dict[str, Any]  # JSON schema for the arguments object
    fn: Callable[..., str] = field(repr=False, default=lambda: "")

    def schema(self) -> dict[str, Any]:
        return {
            "type": "function",
            "function": {
                "name": self.name,
                "description": self.description,
                "parameters": self.parameters,
            },
        }

    def invoke(self, arguments: str) -> str:
        try:
            kwargs = json.loads(arguments) if arguments.strip() else {}
        except json.JSONDecodeError as e:
            return f"invalid function arguments: {e}"
        if not isinstance(kwargs, dict):
            return "function arguments must be a JSON object"
        try:
            return self.fn(**kwargs)
        except ToolError as e:
            return f"Tool {self.name} failed with error {e}."
        except TypeError as e:
            return f"Bad arguments for {self.name}: {e}"


def kubectl_function() -> AgentFunction:
    from ..tools.kubectl import kubectl

    return AgentFunction(
        name="kubectl",
        description=(
            "Run a kubectl command against the current cluster. Provide the "
            "full command line; pipes are allowed. Prefer narrow queries "
            "(jsonpath/custom-columns/--no-headers) over full -o json/yaml dumps."
        ),
        parameters={
            "type": "object",
            "properties": {
                "command": {
                    "type": "string",
                    "description": "The kubectl command line to execute",
                }
            },
            "required": ["command"],
        },
        fn=lambda command: kubectl(command),
    )


def python_function() -> AgentFunction:
    from ..tools.python_tool import python_repl

    return AgentFunction(
        name="python",
        description="Execute a Python 3 script; its stdout is returned.",
        parameters={
            "type": "object",
            "properties": {
                "script": {"type": "string", "description": "Python 3 source"}
            },
            "required": ["script"],
        },
        fn=lambda script: python_repl(script),
    )


def trivy_function() -> AgentFunction:
    from ..tools.trivy import trivy

    return AgentFunction(
        name="trivy",
        description="Scan a container image for vulnerabilities with trivy.",
        parameters={
            "type": "object",
            "properties": {
                "image": {"type": "string", "description": "Image reference"}
            },
            "required": ["image"],
        },
        fn=lambda image: trivy(image),
    )


def run_function_agent(
    client: ChatClient,
    model: str,
    instructions: str,
    user_input: str,
    functions: list[AgentFunction],
    max_turns: int = 30,
    max_tokens: int = 2048,
) -> tuple[str, list[dict[str, Any]]]:
    """Run the tool_calls loop; returns (final text, chat history)."""
    messages: list[dict[str, Any]] = [
        {"role": "system", "content": instructions},
        {"role": "user", "content": user_input},
    ]
    by_name = {f.name: f for f in functions}
    tools = [f.schema() for f in functions] or None
    for _ in range(max_turns):
        resp = client.chat_completion(
            model, messages, max_tokens=max_tokens, tools=tools
        )
        choices = resp.get("choices") or []
        if not choices:
            return "", messages
        msg = choices[0].get("message", {})
        messages.append(msg)
        tool_calls = msg.get("tool_calls") or []
        if not tool_calls:
            return msg.get("content") or "", messages
        for tc in tool_calls:
            fn_name = tc.get("function", {}).get("name", "")
            args = tc.get("function", {}).get("arguments", "")
            func = by_name.get(fn_name)
            if func is None:
                result = f"Tool {fn_name} is not available."
            else:
                log.info("tool_call %s(%s)", fn_name, args[:200])
                result = func.invoke(args)
            messages.append(
                {
                    "role": "tool",
                    "tool_call_id": tc.get("id", ""),
                    "content": result,
                }
            )
    return "(max turns reached)", messages
