"""Tool layer: the agent's action dispatch surface (the port's copy of
``opsagent_tpu/tools/__init__.py``).

A tool is ``Callable[[str], str]`` that raises ``ToolError`` on failure; the
registry maps tool names to callables and is the extension hook.

``ToolPrompt`` is the ReAct wire format the agent and the model exchange: a
JSON object with keys question / thought / action{name,input} / observation
/ final_answer.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Callable, Any

from ..utils.jsonrepair import parse_json


class ToolError(Exception):
    """Raised by a tool on failure; the message becomes the observation."""


Tool = Callable[[str], str]


@dataclass
class ToolAction:
    name: str = ""
    input: str = ""


@dataclass
class ToolPrompt:
    """The ReAct JSON wire format."""

    question: str = ""
    thought: str = ""
    action: ToolAction = field(default_factory=ToolAction)
    observation: str = ""
    final_answer: str = ""

    def to_dict(self) -> dict[str, Any]:
        return {
            "question": self.question,
            "thought": self.thought,
            "action": {"name": self.action.name, "input": self.action.input},
            "observation": self.observation,
            "final_answer": self.final_answer,
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), ensure_ascii=False)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ToolPrompt":
        if not isinstance(d, dict):
            raise ValueError("ToolPrompt payload is not an object")
        act = d.get("action") or {}
        if isinstance(act, str):
            # Some models emit "action": "kubectl get ns" — treat as name.
            act = {"name": act, "input": d.get("action_input", "")}

        def _s(v: Any) -> str:
            if v is None:
                return ""
            if isinstance(v, str):
                return v
            return json.dumps(v, ensure_ascii=False)

        return cls(
            question=_s(d.get("question")),
            thought=_s(d.get("thought")),
            action=ToolAction(name=_s(act.get("name")), input=_s(act.get("input"))),
            observation=_s(d.get("observation")),
            final_answer=_s(d.get("final_answer")),
        )

    @classmethod
    def from_json(cls, s: str) -> "ToolPrompt":
        return cls.from_dict(parse_json(s))


def default_registry() -> dict[str, Tool]:
    """The built-in tool registry: {search, python, trivy, kubectl, jq}."""
    from .kubectl import kubectl
    from .python_tool import python_repl
    from .trivy import trivy
    from .jq import jq
    from .search import google_search

    return {
        "kubectl": kubectl,
        "python": python_repl,
        "trivy": trivy,
        "jq": jq,
        "search": google_search,
    }


# Mutable module-level registry; tests and embedders replace its entries.
copilot_tools: dict[str, Tool] = {}


def get_tools() -> dict[str, Tool]:
    if not copilot_tools:
        copilot_tools.update(default_registry())
    return copilot_tools


# -- conveyor launch readiness ---------------------------------------------
#
# Each tool module declares LAUNCH_FIELDS: the logical argument names that
# suffice to START its subprocess (conveyor partial execution,
# agent/conveyor.py). The ReAct wire format carries every tool's arguments
# in the single ``action.input`` string, so each logical field maps onto
# the ``input`` wire field here; a richer wire format (native tool_calls)
# would map them onto distinct JSON fields instead.

LAUNCH_READY: dict[str, tuple[str, ...]] = {
    "kubectl": ("command",),
    "python": ("script",),
    "trivy": ("image",),
    "jq": ("data", "expr"),
}

_WIRE_FIELD = "input"


def launch_ready_fields(name: str) -> tuple[str, ...]:
    """Logical argument fields that must have closed before ``name`` may
    launch. Unknown-but-registered tools conservatively require their
    full input."""
    return LAUNCH_READY.get(name, (_WIRE_FIELD,))


def wire_fields_for(name: str) -> frozenset[str]:
    """The JSON wire fields carrying the launch-ready arguments — on the
    ReAct single-input wire every logical field rides in ``input``."""
    return frozenset(
        _WIRE_FIELD for _ in launch_ready_fields(name)
    ) or frozenset((_WIRE_FIELD,))
